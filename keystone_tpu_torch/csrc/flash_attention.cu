// K2: the fused flash-attention forward of LM prefill.
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
// H100 SXM datasheet's 989 TFLOP/s bf16 peak. At the 128-token prompt the
// bytes do: 2.5 µs at its 3.35 TB/s.
//
// Design (simple first version): one block per (b·h, 64-row q tile),
// looping over 64-key K/V tiles staged in shared memory. Causal tiles
// wholly above the diagonal are skipped, as num_k_live does on the TPU.
//
// - bf16: four warps of 16 q rows each. Q·Kᵀ and P·V run on the tensor
//   cores through mma.sync m16n8k16 (bf16 in, f32 accumulate). The scaled
//   Q tile is held in registers as A fragments, K sits row-major in shared
//   memory (a column-major B operand as it stands), V is stored transposed
//   so that its B fragments are 32-bit loads. The S accumulators of two
//   neighbouring n8 tiles are exactly the A fragment of the next k16 step,
//   so P never leaves registers. The m, l state lives in registers; the
//   row reductions are quad shuffles.
// - f32: CUDA-core FMAs, never TF32, so f32 stays f32. 256 threads, four
//   per q row; the S tile goes through shared memory.
//
// Left for later: wgmma with TMA loads and a multi-stage K/V ring,
// ldmatrix, and a persistent grid that balances causal tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- bf16

template <int DMAX, typename TOut>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   TOut* __restrict__ out, float* __restrict__ lse, int s_q,
                   int s_k, int d, int q_tiles, int q_offset, int k_offset,
                   int causal, float scale, int vec) {
  constexpr int kPad = 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK][DMAX + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DMAX][kBK + kPad];

  const int bh = blockIdx.x / q_tiles;
  const int q_row0 = (blockIdx.x % q_tiles) * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t k_base = static_cast<size_t>(bh) * s_k * d;

  // the scaled Q tile, rounded to bf16, staged through k_s
  for (int i = tid; i < kBQ * DMAX; i += blockDim.x) {
    const int r = i / DMAX, c = i % DMAX;
    const int row = q_row0 + r;
    float x = 0.f;
    if (row < s_q && c < d) {
      x = __bfloat162float(q[q_base + static_cast<size_t>(row) * d + c]) *
          scale;
    }
    k_s[r][c] = __float2bfloat16_rn(x);
  }
  __syncthreads();
  uint32_t qf[DMAX / 16][4];
  const int r_lo = warp * 16 + g;
#pragma unroll
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(&k_s[r_lo][c]);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(&k_s[r_lo + 8][c]);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(&k_s[r_lo][c + 8]);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(&k_s[r_lo + 8][c + 8]);
  }
  __syncthreads();

  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};
  float o[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  const long long qi_lo = q_row0 + r_lo;  // this thread's rows: lo, lo + 8
  const int live = num_live_tiles(causal, q_row0, q_offset, k_offset, s_k);
  for (int kt = 0; kt < live; ++kt) {
    const int key0 = kt * kBK;
    if (vec) {
      constexpr int kChunks = DMAX / 8;
      for (int i = tid; i < kBK * kChunks; i += blockDim.x) {
        const int j = i / kChunks, c = (i % kChunks) * 8;
        const int kj = key0 + j;
        uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
        if (kj < s_k && c < d) {
          const size_t off = k_base + static_cast<size_t>(kj) * d + c;
          kw = *reinterpret_cast<const uint4*>(k + off);
          vw = *reinterpret_cast<const uint4*>(v + off);
        }
        *reinterpret_cast<uint4*>(&k_s[j][c]) = kw;
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vw);
#pragma unroll
        for (int x = 0; x < 8; ++x) vt_s[c + x][j] = vb[x];
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < kBK * DMAX; i += blockDim.x) {
        const int j = i / DMAX, c = i % DMAX;
        const int kj = key0 + j;
        const bool in = kj < s_k && c < d;
        const size_t off = k_base + static_cast<size_t>(kj) * d + c;
        k_s[j][c] = in ? k[off] : zero;
        vt_s[c][j] = in ? v[off] : zero;
      }
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int c = ks * 16 + 2 * t;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][c]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&k_s[nt * 8 + g][c + 8]);
        mma_bf16(s[nt], qf[ks], b0, b1);
      }
    }

    // mask, row max (quad shuffles), p, row sum
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = key0 + nt * 8 + 2 * t + (e & 1);
        const long long qi = qi_lo + (e >= 2 ? 8 : 0);
        if (!key_valid(causal, qi, kj, s_k, q_offset, k_offset)) s[nt][e] = kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = key0 + nt * 8 + 2 * t + (e & 1);
        const long long qi = qi_lo + (e >= 2 ? 8 : 0);
        const float p = key_valid(causal, qi, kj, s_k, q_offset, k_offset)
                            ? expf(s[nt][e] - m_i[e >> 1])
                            : 0.f;
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // P (rounded to bf16) · V: two n8 tiles of S are one k16 A fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < DMAX / 8; ++dt) {
        const int c = kk * 16 + 2 * t;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&vt_s[dt * 8 + g][c]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&vt_s[dt * 8 + g][c + 8]);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long qi = qi_lo + 8 * r;
    if (qi >= s_q) continue;
    const float den = fmaxf(l_i[r], 1e-30f);
    TOut* row = out + q_base + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) store_out(row + c, o[dt][2 * r] / den);
      if (c + 1 < d) store_out(row + c + 1, o[dt][2 * r + 1] / den);
    }
    if (lse != nullptr && t == 0) {
      lse[static_cast<size_t>(bh) * s_q + qi] = m_i[r] + logf(den);
    }
  }
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

template <int DMAX, typename TOut>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int bh, int s_q, int s_k, int d, int q_offset,
                int k_offset, int causal, float scale, cudaStream_t s) {
  const int q_tiles = (s_q + kBQ - 1) / kBQ;
  const int vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  flash_fwd_bf16<DMAX, TOut>
      <<<static_cast<unsigned>(bh) * q_tiles, 128, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<TOut*>(out), lse,
          s_q, s_k, d, q_tiles, q_offset, k_offset, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (q, k, v). out_dtype: 0 = float32,
// 1 = bfloat16; float32 inputs take float32 output only. lse may be null.
// scale is 1/√D already rounded to the input dtype.
extern "C" int keystone_flash_attention(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int bh, int s_q, int s_k, int d,
                                        int q_offset, int k_offset,
                                        int causal, float scale,
                                        int in_dtype, int out_dtype,
                                        void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k < 0 || d <= 0 || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (in_dtype == 0 && out_dtype == 0) {
    return d <= 64 ? launch_f32<64>(q, k, v, out, l, bh, s_q, s_k, d,
                                    q_offset, k_offset, causal, scale, s)
                   : launch_f32<128>(q, k, v, out, l, bh, s_q, s_k, d,
                                     q_offset, k_offset, causal, scale, s);
  }
  if (in_dtype == 1 && out_dtype == 1) {
    return d <= 64
               ? launch_bf16<64, __nv_bfloat16>(q, k, v, out, l, bh, s_q, s_k,
                                                d, q_offset, k_offset, causal,
                                                scale, s)
               : launch_bf16<128, __nv_bfloat16>(q, k, v, out, l, bh, s_q,
                                                 s_k, d, q_offset, k_offset,
                                                 causal, scale, s);
  }
  if (in_dtype == 1 && out_dtype == 0) {
    return d <= 64
               ? launch_bf16<64, float>(q, k, v, out, l, bh, s_q, s_k, d,
                                        q_offset, k_offset, causal, scale, s)
               : launch_bf16<128, float>(q, k, v, out, l, bh, s_q, s_k, d,
                                         q_offset, k_offset, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
