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
// TF32, so f32 stays f32), in two kernels: S_k ≤ 64 (one key tile, ViT's
// call) takes flash_fwd_f32_short, written for the bytes (below); longer
// keys take flash_fwd_f32, 256 threads, four per q row, the S tile through
// shared memory, which serves the f32 equivalence checks.
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

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device, once per device: the attribute is the device's, so a process
// that launches on a second card sets it there too.
template <class Kernel>
cudaError_t opt_in_smem(bool (&configured)[sm90::kMaxDevices], Kernel kernel,
                        int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < sm90::kMaxDevices && configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < sm90::kMaxDevices) configured[dev] = true;
  return err;
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int s_q, int s_k, int d, int q_offset,
               int k_offset, int causal, float scale, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(F32Smem<DMAX>));
  static bool configured[sm90::kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(configured, flash_fwd_f32<DMAX>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (s_q + kBQ - 1) / kBQ;
  flash_fwd_f32<DMAX><<<static_cast<unsigned>(bh) * q_tiles, 256, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s_q, s_k,
      d, q_tiles, q_offset, k_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ f32, short keys
//
// K2's f32 calls whose keys fit one 64-key tile (S_k ≤ 64), the same
// Pallas flash_attention's: ViT's (B·H 2,048, S 16, D 32) call, once a
// block, 472 times a `vit_ridge` run. With one tile the online softmax is
// a plain one: m the row max, p = exp(s − m) (0 where masked), l = Σp,
// out = (Σ p·v) / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds it: q, k, v read once and out written once, 16.8 MB at
// ViT's shape, 5.0 µs at the H100's 3.35 TB/s; its 67 MFLOP take 1.0 µs
// at 67 TFLOP/s of f32 FMAs. So it has to move bytes well: a block takes
// the heads of a contiguous range of each tensor (a head's q, k and v are
// S·D slabs) into shared memory by 16-byte cp.async, every copy of the
// block in flight at once, and about four blocks of 128 threads land on
// each SM (about 100 KB of loads in flight an SM at ViT's shape). A warp
// takes R = 32 / T q rows of one head, T = S_k-tile / 8 lanes a row, so
// each lane holds the scores of 8 keys (t, t + T, …) in registers; the row
// max and sum are warp shuffles, and P·V takes each p from its lane by a
// shuffle, so p never passes through shared memory. A lane then owns D / T
// output columns in 4-column chunks (t, t + T, …): the T lanes of a row
// write T · 16 contiguous bytes a store. q and k rows sit D + 4 floats
// apart in shared memory, so the rows a warp reads at once fall on
// different banks. D is a template parameter, exact at 32, 64 and 128 and
// rounded up from the others (loops stop at D); the key tile is 16, 32 or
// 64 keys. Rows that are not 16-byte aligned (D % 4 ≠ 0, or a base off
// 16 bytes) take 4-byte copies, loads and stores, at D ≤ 128 and 64 keys.
// FMAs on CUDA cores, never TF32. On an NVIDIA H100 80GB HBM3 at 700 W it
// takes 9.0–9.5 µs at ViT's shape (chip_smoke.py, phase 26), 53–56 % of
// the bound; at (1,344 heads, 16, 32), 3.3 µs of bytes, it still takes
// 8.0–8.7 µs, so a launch's fixed latency (the first loads' round trip,
// the last block's products and stores) is most of the rest.

constexpr int kShortWarps = 4;
constexpr int kShortThreads = 32 * kShortWarps;
constexpr int kShortQTile = 64;  // q rows of a head a block takes at most
constexpr int kKeysPerLane = 8;
// the largest block: one head of 64 q rows against 64 keys at D = 128
constexpr int kShortSmemCap = 4 * kShortQTile * (3 * 128 + 8);

// A launch's blocking: heads a block (whole heads, q_rows = S_q, when more
// than one), q rows of a head a block, shared memory.
struct ShortPlan {
  int heads, q_rows, q_tiles, smem;
};

inline ShortPlan short_plan(int dt, int kmax, int bh, int s_q, int s_k) {
  const int rows_a_warp = 32 / (kmax / kKeysPerLane);
  ShortPlan p;
  p.q_rows = s_q < kShortQTile ? s_q : kShortQTile;
  p.q_tiles = (s_q + p.q_rows - 1) / p.q_rows;
  const int groups = (p.q_rows + rows_a_warp - 1) / rows_a_warp;
  const int head_bytes = 4 * (p.q_rows * (dt + 4) + s_k * (2 * dt + 4));
  int heads = kShortWarps / groups;  // a warp a row group
  if (heads > kShortSmemCap / head_bytes) heads = kShortSmemCap / head_bytes;
  if (heads > bh) heads = bh;
  p.heads = heads < 1 ? 1 : heads;
  p.smem = p.heads * head_bytes;
  return p;
}

// W floats: one 16-byte access, or one 4-byte one
template <int W>
__device__ __forceinline__ void lds(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void stg(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// `rows` rows of d floats, contiguous at src, to rows `pitch` floats apart
// at dst, W floats a cp.async; the row and column of each copy are carried
// from one copy to the next, so no copy divides.
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, int pitch, const float* src,
                                          int rows, int d) {
  const int w = d / W;  // copies a row
  const int n = rows * w;
  int i = threadIdx.x;
  int row = i / w, c = i - row * w;
  const int dr = kShortThreads / w, dc = kShortThreads - dr * w;
  for (; i < n; i += kShortThreads) {
    const uint32_t s = sm90::smem_u32(dst + row * pitch + c * W);
    const float* g = src + static_cast<size_t>(i) * W;
    if constexpr (W == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g) : "memory");
    }
    row += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++row;
    }
  }
}

// DT: D rounded up (32, 64, 128); KMAX: S_k rounded up (16, 32, 64); VEC:
// every row 16-byte aligned (D % 4 == 0 and the four bases aligned).
template <int DT, int KMAX, bool VEC>
__global__ void __launch_bounds__(kShortThreads)
    flash_fwd_f32_short(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int bh, int s_q, int s_k, int d,
                        int heads, int q_rows, int q_tiles, int q_offset,
                        int k_offset, int causal, float scale) {
  constexpr int T = KMAX / kKeysPerLane;  // lanes a q row
  constexpr int R = 32 / T;               // q rows a warp
  constexpr int W = VEC ? 4 : 1;          // floats an access
  constexpr int P = DT + 4;               // q and k row pitch in shared memory
  constexpr int NCOL = DT / (W * T);      // output accesses a lane
  extern __shared__ __align__(16) float smem[];

  const int tile = blockIdx.x / q_tiles;
  const int head0 = tile * heads;
  const int q0 = (blockIdx.x - tile * q_tiles) * q_rows;
  const int nh = min(heads, bh - head0);
  const int nq = min(q_rows, s_q - q0);
  float* qs = smem;
  float* ks = qs + heads * q_rows * P;
  float* vs = ks + heads * s_k * P;
  // one contiguous range of each tensor (several heads a block only take
  // whole heads: q_rows = S_q, q0 = 0)
  copy_rows<W>(qs, P, q + (static_cast<size_t>(head0) * s_q + q0) * d, (nh - 1) * s_q + nq, d);
  copy_rows<W>(ks, P, k + static_cast<size_t>(head0) * s_k * d, nh * s_k, d);
  copy_rows<W>(vs, DT, v + static_cast<size_t>(head0) * s_k * d, nh * s_k, d);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / T, t = lane % T;
  const int groups = (nq + R - 1) / R;
  for (int item = warp; item < nh * groups; item += kShortWarps) {
    const int hh = item / groups, g = item - hh * groups;
    const bool live = g * R + r < nq;
    const int row = live ? g * R + r : nq - 1;  // a row past the tile repeats the last
    const float* qrow = qs + (hh * q_rows + row) * P;
    const float* kh = ks + hh * s_k * P;
    const float* vh = vs + hh * s_k * DT;

    // scores of keys t + T·x, q·scale rounded to f32 first
    float sc[kKeysPerLane];
#pragma unroll
    for (int x = 0; x < kKeysPerLane; ++x) sc[x] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DT; c += W) {
      if (c >= d) break;
      float qv[W];
      lds<W>(qv, qrow + c);
#pragma unroll
      for (int e = 0; e < W; ++e) qv[e] *= scale;
#pragma unroll
      for (int x = 0; x < kKeysPerLane; ++x) {
        if (t + T * x < s_k) {
          float kv[W];
          lds<W>(kv, kh + (t + T * x) * P + c);
#pragma unroll
          for (int e = 0; e < W; ++e) sc[x] = fmaf(qv[e], kv[e], sc[x]);
        }
      }
    }

    const long long qi = static_cast<long long>(q0) + row;
    bool valid[kKeysPerLane];
    float m = kNeg;
#pragma unroll
    for (int x = 0; x < kKeysPerLane; ++x) {
      valid[x] = key_valid(causal, qi, t + T * x, s_k, q_offset, k_offset);
      if (!valid[x]) sc[x] = kNeg;
      m = fmaxf(m, sc[x]);
    }
#pragma unroll
    for (int o = 1; o < T; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
#pragma unroll
    for (int x = 0; x < kKeysPerLane; ++x) {
      sc[x] = valid[x] ? expf(sc[x] - m) : 0.f;  // p
      l += sc[x];
    }
#pragma unroll
    for (int o = 1; o < T; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);

    // P·V: key j's p comes from lane (r, j % T); columns (t + T·cc)·W
    float acc[NCOL][W];
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[cc][e] = 0.f;
    }
    const int base = lane & ~(T - 1);
#pragma unroll
    for (int x = 0; x < kKeysPerLane; ++x) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const int j = T * x + u;
        if (j < s_k) {  // the same key on every lane
          const float pj = __shfl_sync(0xffffffffu, sc[x], base | u);
          const float* vrow = vh + j * DT;
#pragma unroll
          for (int cc = 0; cc < NCOL; ++cc) {
            const int col = (t + T * cc) * W;
            if (col < d) {
              float vv[W];
              lds<W>(vv, vrow + col);
#pragma unroll
              for (int e = 0; e < W; ++e) acc[cc][e] = fmaf(pj, vv[e], acc[cc][e]);
            }
          }
        }
      }
    }

    if (live) {
      const float den = fmaxf(l, 1e-30f);
      const size_t orow = static_cast<size_t>(head0 + hh) * s_q + qi;
#pragma unroll
      for (int cc = 0; cc < NCOL; ++cc) {
        const int col = (t + T * cc) * W;
        if (col < d) {
          float o[W];
#pragma unroll
          for (int e = 0; e < W; ++e) o[e] = acc[cc][e] / den;
          stg<W>(out + orow * d + col, o);
        }
      }
      if (lse != nullptr && t == 0) lse[orow] = m + logf(den);
    }
  }
}

template <int DT, int KMAX, bool VEC>
int launch_short(const void* q, const void* k, const void* v, void* out,
                 float* lse, int bh, int s_q, int s_k, int d, int q_offset,
                 int k_offset, int causal, float scale, cudaStream_t s) {
  static bool configured[sm90::kMaxDevices] = {};
  const cudaError_t err =
      opt_in_smem(configured, flash_fwd_f32_short<DT, KMAX, VEC>, kShortSmemCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ShortPlan p = short_plan(DT, KMAX, bh, s_q, s_k);
  const unsigned blocks = static_cast<unsigned>((bh + p.heads - 1) / p.heads) * p.q_tiles;
  flash_fwd_f32_short<DT, KMAX, VEC><<<blocks, kShortThreads, p.smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, bh, s_q, s_k,
      d, p.heads, p.q_rows, p.q_tiles, q_offset, k_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_short_keys(const void* q, const void* k, const void* v, void* out,
                      float* lse, int bh, int s_q, int s_k, int d, int q_offset,
                      int k_offset, int causal, float scale, cudaStream_t s) {
  if (s_k <= 16) {
    return launch_short<DT, 16, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                      k_offset, causal, scale, s);
  }
  if (s_k <= 32) {
    return launch_short<DT, 32, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                      k_offset, causal, scale, s);
  }
  return launch_short<DT, 64, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                    k_offset, causal, scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows 16-byte aligned: D % 4 == 0 and every base aligned.
bool rows_aligned(const void* q, const void* k, const void* v, const void* out, int d) {
  return d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

// S_k ≤ 64: the short-key kernel at D rounded up to 32, 64 or 128.
int launch_f32_short(const void* q, const void* k, const void* v, void* out,
                     float* lse, int bh, int s_q, int s_k, int d, int q_offset,
                     int k_offset, int causal, float scale, cudaStream_t s) {
  if (!rows_aligned(q, k, v, out, d)) {
    return launch_short<128, 64, false>(q, k, v, out, lse, bh, s_q, s_k, d,
                                        q_offset, k_offset, causal, scale, s);
  }
  if (d <= 32) {
    return launch_short_keys<32>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                 k_offset, causal, scale, s);
  }
  if (d <= 64) {
    return launch_short_keys<64>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                 k_offset, causal, scale, s);
  }
  return launch_short_keys<128>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset,
                                k_offset, causal, scale, s);
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
    if (s_k <= kBK) {
      return launch_f32_short(q, k, v, out, l, bh, s_q, s_k, d, q_offset,
                              k_offset, causal, scale, s);
    }
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

// Dynamic shared memory a block of the f32 kernel that (bh, s_q, s_k, d)
// takes: the short-key kernel, its rows 16-byte aligned (vec) or not, or
// the tiled one past 64 keys.
extern "C" int keystone_flash_attention_f32_smem_bytes(int bh, int s_q, int s_k,
                                                       int d, int vec) {
  if (s_k > kBK) {
    return static_cast<int>(d <= 64 ? sizeof(F32Smem<64>) : sizeof(F32Smem<128>));
  }
  const int dt = !vec ? 128 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  const int kmax = !vec ? 64 : s_k <= 16 ? 16 : s_k <= 32 ? 32 : 64;
  return short_plan(dt, kmax, bh, s_q, s_k).smem;
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
