// K2: the fused flash-attention forward of LM prefill and local scoring.
//
// Replaces keystone_tpu/ops/flash_attention.py::flash_attention (Pallas
// kernels _flash_kernel_fori and _flash_kernel_stream). Computes
// softmax(q·kᵀ/√D)·v for q (BH, S_q, D) and k, v (BH, S_k, D), row-major,
// with the online softmax (running max m, sum l and an f32 accumulator)
// and optionally the row logsumexp. Key j is valid when j < S_k and, when
// causal, when q_offset + i ≥ k_offset + j (begin-aligned positions).
// Masked scores are −1e30 and their p is set to 0, so a fully masked row
// outputs 0. The TPU kernel's rounding points are kept: q·scale rounded to
// q's dtype, p rounded to v's dtype before the PV product, out = acc /
// max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds it on an H100: causal attention needs 4·B·H·D·S(S+1)/2
// operations against 8·B·H·S·D bytes (q, k, v read, o written, bf16). At
// D = 64, B·H = 128 and S = 2,048 the operations bound it: 69.5 µs at the
// H100 SXM datasheet's 989 TFLOP/s bf16 peak; at the scoring shape (B·H 32,
// S 8,192) 278 µs. At the 128-token prompt the bytes do: 2.5 µs at its
// 3.35 TB/s. Only wgmma reaches the bf16 peak, and the exponentials (one
// per score, on the special-function units) cost about half as much as the
// two products at D = 64.
//
// Design: the bf16 path is the Hopper mainloop of attention_sm90.cuh: 192 q
// rows a block in three consumer warpgroups (128 in two at D > 64), K/V
// tiles of 64 keys arriving by TMA into a 4-stage ring under a producer
// warpgroup, S = Q·Kᵀ and O += P·V on wgmma with P in registers and V read
// through the transpose bit, one tile's softmax beside the previous tile's
// P·V, masking compiled only into tiles that need it, q tiles heaviest
// first, a persistent grid without causality. The K2 state policy below
// starts each row fresh, scales q in shared memory (rounded to bf16)
// before the product, rounds p to bf16 (one P pass), and writes out (in
// 16-byte chunks) and lse. The f32 path stays on CUDA cores (FMAs, never
// TF32, so f32 stays f32): 256 threads, four per q row, the S tile through
// shared memory; it serves the f32 equivalence checks.
//
// Left for later: ping-pong scheduling of the consumer warpgroups (one's
// softmax against the other's products), the output through shared
// memory and a TMA store, and exponentials shared with the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_sm90.cuh"

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per K/V tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ int num_live_tiles(int causal, long long q_row0,
                                              int q_offset, int k_offset,
                                              int s_k) {
  const int num_k = (s_k + kBK - 1) / kBK;
  if (!causal) return num_k;
  // keys up to the tile's last q position: tiles past it are all masked
  const long long span = q_offset + q_row0 + kBQ - k_offset;
  if (span <= 0) return 0;
  const long long live = (span + kBK - 1) / kBK;
  return live < num_k ? static_cast<int>(live) : num_k;
}

__device__ __forceinline__ bool key_valid(int causal, long long qi, int kj,
                                          int s_k, int q_offset,
                                          int k_offset) {
  if (kj >= s_k) return false;
  return !causal || static_cast<long long>(q_offset) + qi >=
                        static_cast<long long>(k_offset) + kj;
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// eight values to 16-byte-aligned memory
__device__ __forceinline__ void store8(float* p, const float2 (&x)[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[2].x, x[2].y, x[3].x, x[3].y);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float2 (&x)[4]) {
  uint4 w;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x[i].x, x[i].y);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = w;
}

// ---------------------------------------------------------------- bf16

// K2's policy for the Hopper mainloop: a fresh state, q scaled in bf16,
// p rounded once, out = acc / max(l, 1e-30) and lse written at the end.
template <typename TOut>
struct K2State {
  static constexpr int kPasses = 1;
  static constexpr bool kScaleQ = true;
  TOut* out;
  float* lse;  // may be null

  template <int N>
  __device__ void load(const sm90::Shape&, int, const int (&)[2], int,
                       float (&m)[2], float (&l)[2], float (&o)[N]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = 0.f;
  }

  // Each row's 8-column chunks as 16-byte stores where the rows allow
  // (D a multiple of 8), else element by element.
  template <int N>
  __device__ void store(const sm90::Shape& sh, int bh, const int (&row)[2],
                        int t, const float (&m)[2], const float (&l)[2],
                        const float (&o)[N]) const {
    const bool vec = sh.d % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < sh.s_q;
      const float den = fmaxf(l[r], 1e-30f);
      const size_t base = static_cast<size_t>(bh) * sh.s_q + row[r];
      TOut* dst = out + base * sh.d;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        float2 x[4];
        sm90::row_chunk(o, r, j, t, 1.f / den, x);  // one division a row
        const int c0 = 8 * (4 * j + t);
        if (!in) continue;
        if (vec && c0 + 8 <= sh.d) {
          store8(dst + c0, x);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (c0 + 2 * p < sh.d) store_out(dst + c0 + 2 * p, x[p].x);
            if (c0 + 2 * p + 1 < sh.d) store_out(dst + c0 + 2 * p + 1, x[p].y);
          }
        }
      }
      if (in && lse != nullptr && t == 0) lse[base] = m[r] + logf(den);
    }
  }
};

template <typename TOut>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int bh, int s_q, int s_k, int d, int d_in,
                int q_offset, int k_offset, int causal, float scale,
                int* sched, cudaStream_t s) {
  const sm90::Shape sh{s_q, s_k, d, 0, bh, q_offset, k_offset, causal, scale, 0, sched};
  const K2State<TOut> st{static_cast<TOut*>(out), lse};
  return d_in <= 64 ? sm90::launch<64>(q, k, v, d_in, sh, st, s)
                    : sm90::launch<128>(q, k, v, d_in, sh, st, s);
}

// ----------------------------------------------------------------- f32

template <int DMAX>
struct F32Smem {
  float q[kBQ][DMAX + 1];
  float k[kBK][DMAX + 1];
  float v[kBK][DMAX];
  float p[kBQ][kBK + 1];
};

template <int DMAX>
__global__ void __launch_bounds__(256)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int s_q, int s_k, int d,
                  int q_tiles, int q_offset, int k_offset, int causal,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem<DMAX>& sm = *reinterpret_cast<F32Smem<DMAX>*>(smem_raw);

  const int bh = blockIdx.x / q_tiles;
  const int q_row0 = (blockIdx.x % q_tiles) * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / 4, part = tid % 4;  // four threads per q row
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t k_base = static_cast<size_t>(bh) * s_k * d;

  for (int i = tid; i < kBQ * DMAX; i += blockDim.x) {
    const int rr = i / DMAX, c = i % DMAX;
    const int row = q_row0 + rr;
    sm.q[rr][c] = (row < s_q && c < d)
                      ? q[q_base + static_cast<size_t>(row) * d + c] * scale
                      : 0.f;
  }

  float m_i = kNeg, l_i = 0.f;
  constexpr int kCols = DMAX / 4;  // output columns part + 4·x
  float o[kCols];
#pragma unroll
  for (int x = 0; x < kCols; ++x) o[x] = 0.f;

  const long long qi = q_row0 + r;
  const int live = num_live_tiles(causal, q_row0, q_offset, k_offset, s_k);
  for (int kt = 0; kt < live; ++kt) {
    const int key0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DMAX; i += blockDim.x) {
      const int j = i / DMAX, c = i % DMAX;
      const int kj = key0 + j;
      const bool in = kj < s_k && c < d;
      const size_t off = k_base + static_cast<size_t>(kj) * d + c;
      sm.k[j][c] = in ? k[off] : 0.f;
      sm.v[j][c] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[kBK / 4];
    float mx = kNeg;
#pragma unroll
    for (int x = 0; x < kBK / 4; ++x) {
      const int j = part + 4 * x;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(sm.q[r][c], sm.k[j][c], acc);
      if (!key_valid(causal, qi, key0 + j, s_k, q_offset, k_offset)) acc = kNeg;
      sc[x] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    m_i = m_new;
    float rs = 0.f;
#pragma unroll
    for (int x = 0; x < kBK / 4; ++x) {
      const int j = part + 4 * x;
      const float p = key_valid(causal, qi, key0 + j, s_k, q_offset, k_offset)
                          ? expf(sc[x] - m_new)
                          : 0.f;
      sm.p[r][j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * alpha + rs;
    __syncwarp();  // the row's p values come from the four threads of a quad

#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      const int c = part + 4 * x;
      float pv = 0.f;
      for (int j = 0; j < kBK; ++j) pv = fmaf(sm.p[r][j], sm.v[j][c], pv);
      o[x] = o[x] * alpha + pv;
    }
  }

  if (qi < s_q) {
    const float den = fmaxf(l_i, 1e-30f);
    float* row = out + q_base + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      const int c = part + 4 * x;
      if (c < d) row[c] = o[x] / den;
    }
    if (lse != nullptr && part == 0) {
      lse[static_cast<size_t>(bh) * s_q + qi] = m_i + logf(den);
    }
  }
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int s_q, int s_k, int d, int q_offset,
               int k_offset, int causal, float scale, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(F32Smem<DMAX>));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int q_tiles = (s_q + kBQ - 1) / kBQ;
  flash_fwd_f32<DMAX><<<static_cast<unsigned>(bh) * q_tiles, 256, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s_q, s_k,
      d, q_tiles, q_offset, k_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (q, k, v). out_dtype: 0 = float32,
// 1 = bfloat16; float32 inputs take float32 output only. lse may be null.
// scale is 1/√D already rounded to the input dtype. q, k and v have rows of
// d_in ≥ d elements: bf16 rows must be 16-byte multiples (d_in % 8 == 0,
// the columns past d zero) and the bases 16-byte aligned, for TMA; the
// output has rows of d. sched is two int32, zero between launches, that
// the bf16 kernel's persistent blocks take their work from.
extern "C" int keystone_flash_attention(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int bh, int s_q, int s_k, int d,
                                        int d_in, int q_offset, int k_offset,
                                        int causal, float scale,
                                        int in_dtype, int out_dtype,
                                        void* sched, void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k < 0 || d <= 0 || d > 128 || d_in < d ||
      d_in > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (in_dtype == 0 && out_dtype == 0 && d_in == d) {
    return d <= 64 ? launch_f32<64>(q, k, v, out, l, bh, s_q, s_k, d,
                                    q_offset, k_offset, causal, scale, s)
                   : launch_f32<128>(q, k, v, out, l, bh, s_q, s_k, d,
                                     q_offset, k_offset, causal, scale, s);
  }
  if (in_dtype == 1 && out_dtype == 1) {
    return launch_bf16<__nv_bfloat16>(q, k, v, out, l, bh, s_q, s_k, d, d_in,
                                      q_offset, k_offset, causal, scale,
                                      static_cast<int*>(sched), s);
  }
  if (in_dtype == 1 && out_dtype == 0) {
    return launch_bf16<float>(q, k, v, out, l, bh, s_q, s_k, d, d_in,
                              q_offset, k_offset, causal, scale,
                              static_cast<int*>(sched), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of the bf16 kernel takes at row width d_in.
extern "C" int keystone_flash_attention_smem_bytes(int d_in) {
  return d_in <= 64 ? sm90::smem_bytes<64, K2State<__nv_bfloat16>>()
                    : sm90::smem_bytes<128, K2State<__nv_bfloat16>>();
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
