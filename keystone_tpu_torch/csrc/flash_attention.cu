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
// 16-byte chunks) and lse.
//
// The f32 path stays on CUDA cores (FMAs, never TF32, so f32 stays f32), in
// two kernels: S_k ≤ 64 (one key tile, ViT's call) takes
// flash_fwd_f32_short, written for the bytes (below); longer keys take the
// tiled flash_fwd_f32 (below), the LM's f32 forwards. Its bound is the f32
// FMA rate: 1.026 ms at (B·H 128, S 2,048, D 64) causal against 67 TFLOP/s,
// 0.17 ms of bytes. An SM issues four warp-FMAs a clock but serves one
// shared-memory wavefront, and a 16-byte load by a warp costs about 2.5
// clocks when each quarter-warp reads at most four addresses and 4 when it
// reads eight (tools/smem_loads.cu); so the FMAs set the
// pace only when each lane keeps a register tile whose loads each feed many
// FMAs. The first tiled kernel
// read both operands of every FMA from shared memory (one wavefront for
// half a warp-FMA: at most 1/8 of the peak; it reached 12.9 %). This one
// keeps 8 × 8 scores and 8 × 8 outputs a lane at D = 64 (one 16-byte load
// for 16 FMAs), lets its warps run apart on an mbarrier ring instead of a
// block barrier, skips each warp's tiles past its own diagonal, and takes
// its exponentials on the special-function unit.
//
// Left for later: ping-pong scheduling of the consumer warpgroups (one's
// softmax against the other's products), the output through shared
// memory and a TMA store, and exponentials shared with the FMA units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "attention_sm90.cuh"

namespace {

constexpr int kBK = 64;  // keys per K/V tile
constexpr float kNeg = -1e30f;

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

// ------------------------------------------------------------ f32, tiled
//
// K2's f32 calls past one key tile (S_k > 64): the LM's f32 prefill,
// scoring and training forwards (the trainer's default (8, 8, 256, 32),
// the f32 legs' (8, 16, 2,048, 64)). A block of 8 warps takes kBQ q rows
// of one head, a warp kWarpRows of them, against the head's 64-key tiles.
// A warp holds kRPW row groups of kKG lanes: lane tx of row group tr owns
// rows tr + kRPW·i (i < kRows) of the warp's, keys kKeys·tx + e of each S
// tile, and output columns of its rows in chunks tx, tx + kKG, … At D =
// 64 that is 8 × 8 scores and 8 × 8 outputs a lane, one 16-byte shared
// load for 16 FMAs. K rows keep 16-byte chunk c at chunk c ^ (row / kKeys
// & 7), q rows at c ^ (row % kRPW · 8 / kRPW), and P rows xor their keys
// by kKG·tr, so no shared load or P store of a warp conflicts; q and P
// loads are one address a quarter-warp, P stores 16 bytes a lane. A row's
// max is a butterfly over its kKG lanes; each lane keeps a partial l over
// its own keys, summed once at the end; p = exp(s − m) by exp_sfu (the
// special-function unit's 2^x, corrected to expf's 2 ulp). P passes through shared memory once a tile, read
// back only by the warp that wrote it. The warps run apart: K/V tiles sit
// in a ring of kStages stages, each with an mbarrier that its copy's
// cp.async completions arrive on; the last warp done with a stage refills
// it, so no barrier holds the block. A warp skips its tiles past its own
// diagonal (exact: they leave its state unchanged), masks are compiled
// only into tiles that cross its diagonal or the ragged end, causal q
// tiles run heaviest first, and q is scaled and rounded once, into shared
// memory. On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 7):
// 2.001 ms at (8, 16, 2,048, 64) causal, 51.3 % of its 1.026 ms bound
// (the first tiled kernel: 7.935; SDPA f32: 2.211). Removal probes
// (tools/k2_tiled_probe.py) put the softmax at about 5 % of that; the
// rest is the two products' issue at two warps a scheduler, 254 registers
// a lane.

// The blocking at D rounded up to DT (32, 64, 128).
template <int DT>
struct Tiled {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kBQ = DT == 32 ? 64 : DT == 64 ? 256 : 128;  // q rows a block
  static constexpr int kKG = DT == 64 ? 8 : 16;                     // lanes a row
  static constexpr int kRPW = 32 / kKG;                            // row groups a warp
  static constexpr int kRows = kBQ / (kThreads / kKG);             // q rows a thread
  static constexpr int kWarpRows = kRPW * kRows;                    // q rows a warp
  static constexpr int kKeys = kBK / kKG;                          // keys a thread, a tile
  static constexpr int kVW = DT / kKG < 4 ? DT / kKG : 4;          // columns a V load
  static constexpr int kNC = DT / (kKG * kVW);                     // V loads a key
  static constexpr int kStages = DT == 128 ? 2 : 3;                // K/V ring
  static constexpr int kMinBlocks = DT == 32 ? 2 : 1;
  // floats: the q tile, the K and V stages, the P tile; then a barrier
  // and a done count a stage
  static constexpr int kSmemFloats = kBQ * DT + 2 * kStages * kBK * DT + kBQ * kBK;
  static constexpr int kSmemBytes = 4 * kSmemFloats + 16 * kStages;
};

__device__ __forceinline__ int num_live_tiles(int causal, long long q_row0, int q_rows,
                                              int q_offset, int k_offset, int s_k) {
  const int num_k = (s_k + kBK - 1) / kBK;
  if (q_rows <= 0) return 0;
  if (!causal) return num_k;
  // keys up to the last q position: tiles past it are all masked
  const long long span = q_offset + q_row0 + q_rows - k_offset;
  if (span <= 0) return 0;
  const long long live = (span + kBK - 1) / kBK;
  return live < num_k ? static_cast<int>(live) : num_k;
}

// Float offset of column `col` of row `row` in a tile of DT-float rows
// whose 16-byte chunk c sits at chunk c ^ x.
template <int DT>
__device__ __forceinline__ int chunk_xor(int row, int col, int x) {
  return row * DT + ((((col >> 2) ^ x) << 2) | (col & 3));
}

// The chunk xor of a K row (the 8 keys a quarter-warp reads at once, one
// of every kKeys, differ in row / kKeys & 7) and of a q row (the kRPW rows
// a warp reads at once differ in row % kRPW).
template <int KEYS>
__device__ __forceinline__ int k_xor(int row) {
  return row / KEYS & 7;
}

template <int RPW>
__device__ __forceinline__ int q_xor(int row) {
  return row % RPW * (8 / RPW);
}

// A lane's walk over the pieces of rows w pieces wide, 32 lanes a step: its
// first piece (row, c) and its step, so that no copy divides.
struct Walk {
  int row, c, dr, dc;
};

__device__ __forceinline__ Walk walk(int first, int w, int lanes) {
  return {first / w, first % w, lanes / w, lanes % w};
}

__device__ __forceinline__ void step(Walk& p, int w) {
  p.row += p.dr;
  p.c += p.dc;
  if (p.c >= w) {
    p.c -= w;
    ++p.row;
  }
}

// One K or V tile by one warp: `rows` rows of d floats, contiguous at src,
// into kBK rows of DT floats at dst (chunk-swizzled for K), W floats a
// cp.async; rows from `rows` on are filled with zeros (a stale value could
// be NaN, and its p of 0 would not clear it). Each lane's copies then
// arrive on `bar` as they complete.
template <int DT, int W, bool SWZ>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int rows, int d,
                                          int lane) {
  const int w = d / W;
  Walk p = walk(lane, w, 32);
  for (int i = lane; i < kBK * w; i += 32, step(p, w)) {
    const int col = p.c * W;
    const uint32_t s = sm90::smem_u32(
        dst + (SWZ ? chunk_xor<DT>(p.row, col, k_xor<Tiled<DT>::kKeys>(p.row)) : p.row * DT + col));
    const int n = p.row < rows ? 4 * W : 0;  // source bytes; the rest is zeroed
    const float* g = n ? src + static_cast<size_t>(i) * W : src;
    if constexpr (W == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(n)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(g), "r"(n)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// exp(x) in four instructions: 2^t on the special-function unit
// (ex2.approx, 2 ulp) for t = x·log2 e rounded to f32, times 1 + c for what
// that rounding dropped, c = x − t·ln 2 by one FMA (x and t·ln 2 nearly
// cancel). 2^t alone would be off by up to |x|·2^-24 relative, 29 ulp for
// |x| ≤ 30; the rounding of t, c and the product leave at most 2.3 ulp
// there (tests/test_torch_flash.py models it), beside ex2's own 2 (expf:
// 2 in all). Results below 2^-126 flush to 0; exp(−1e30) is 0.
__device__ __forceinline__ float exp_sfu(float x) {
  const float t = x * 1.44269502f;  // log2 e, rounded to f32
  const float c = fmaf(-t, 0.693147182f, x);  // ln 2, rounded to f32
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  return fmaf(y, c, y);
}

// The online softmax of one S tile for a thread's rows, each step over
// all rows at once so that the rows' shuffles and exponentials overlap:
// the mask (MASK tiles only, by selects), the row max by a butterfly over
// the row's kKG lanes, p into the P tile, the partial l and the output
// rescaled by alpha.
template <int DT, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[Tiled<DT>::kRows][Tiled<DT>::kKeys], float (&m)[Tiled<DT>::kRows],
    float (&lp)[Tiled<DT>::kRows],
    float (&o)[Tiled<DT>::kRows][Tiled<DT>::kNC][Tiled<DT>::kVW], float* prow, int pswz,
    int tx, long long qi0, int kj0, int s_k, int causal, int q_offset, int k_offset) {
  using C = Tiled<DT>;
  bool ok[C::kRows][C::kKeys];
  float mx[C::kRows], alpha[C::kRows];
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    // key kj0 + e is seen by row qi0 + kRPW·i when e ≤ lim
    const long long lim =
        static_cast<long long>(q_offset) + qi0 + C::kRPW * i - k_offset - kj0;
    mx[i] = kNeg;
#pragma unroll
    for (int e = 0; e < C::kKeys; ++e) {
      ok[i][e] = !MASK || (kj0 + e < s_k && (!causal || e <= lim));
      if (MASK) s[i][e] = ok[i][e] ? s[i][e] : kNeg;
      mx[i] = fmaxf(mx[i], s[i][e]);
    }
  }
#pragma unroll
  for (int x = 1; x < C::kKG; x <<= 1) {
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], x));
    }
  }
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = exp_sfu(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    float sum = __fmul_rn(lp[i], alpha[i]);
    float p[C::kKeys];
#pragma unroll
    for (int e = 0; e < C::kKeys; ++e) {
      p[e] = exp_sfu(s[i][e] - m[i]);
      if (MASK) p[e] = ok[i][e] ? p[e] : 0.f;
      sum = __fadd_rn(sum, p[e]);
    }
#pragma unroll
    for (int h = 0; h < C::kKeys; h += 4) {
      *reinterpret_cast<float4*>(prow + C::kRPW * i * kBK + ((C::kKeys * tx + h) ^ pswz)) =
          make_float4(p[h], p[h + 1], p[h + 2], p[h + 3]);
    }
    lp[i] = sum;
#pragma unroll
    for (int cc = 0; cc < C::kNC; ++cc) {
#pragma unroll
      for (int w = 0; w < C::kVW; ++w) o[i][cc][w] = __fmul_rn(o[i][cc][w], alpha[i]);
    }
  }
}

// DT: D rounded up (32, 64, 128); VEC: every row 16-byte aligned (D % 4
// == 0 and the four bases aligned), else 4-byte copies and stores.
template <int DT, bool VEC>
__global__ void __launch_bounds__(Tiled<DT>::kThreads, Tiled<DT>::kMinBlocks)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int bh, int s_q, int s_k, int d, int q_offset,
                  int k_offset, int causal, float scale) {
  using C = Tiled<DT>;
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  constexpr int R = C::kRows, K = C::kKeys, NC = C::kNC, VW = C::kVW, NS = C::kStages;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + C::kBQ * DT;    // NS stages
  float* sv = sk + NS * kBK * DT;  // NS stages
  float* sp = sv + NS * kBK * DT;
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + C::kBQ * kBK);  // a stage's tile landed
  int* done = reinterpret_cast<int*>(full + NS);  // warps done with a stage, cumulative

  const int head = static_cast<int>(blockIdx.x % bh);
  const int q_tiles = (s_q + C::kBQ - 1) / C::kBQ;
  const int q_row0 = (q_tiles - 1 - static_cast<int>(blockIdx.x / bh)) * C::kBQ;  // heaviest first
  const int q_rows = min(C::kBQ, s_q - q_row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = lane % C::kKG, tr = lane / C::kKG;
  const int wrow0 = warp * C::kWarpRows;  // the warp's first row in the block
  const float* kh = k + static_cast<size_t>(head) * s_k * d;
  const float* vh = v + static_cast<size_t>(head) * s_k * d;
  const int live = num_live_tiles(causal, q_row0, q_rows, q_offset, k_offset, s_k);
  const int warp_live = num_live_tiles(causal, q_row0 + wrow0, min(C::kWarpRows, q_rows - wrow0),
                                       q_offset, k_offset, s_k);

  if (live > 0) {
    if (threadIdx.x < NS) {
      sm90::mbar_init(full + threadIdx.x, 32);  // one warp's copies fill a stage
      done[threadIdx.x] = 0;
    }
    if constexpr (!VEC) {  // the pad columns of the last chunk read as 0
      for (int i = threadIdx.x; i < NS * kBK * DT; i += C::kThreads) sk[i] = 0.f;
    }
    __syncthreads();
    if (warp < NS && warp < live) {  // warp t fills stage t with tile t
      const size_t off = static_cast<size_t>(warp) * kBK * d;
      const int rows = min(kBK, s_k - warp * kBK);
      copy_tile<DT, W, true>(sk + warp * kBK * DT, kh + off, rows, d, lane);
      copy_tile<DT, W, false>(sv + warp * kBK * DT, vh + off, rows, d, lane);
      arrive_on_copies(full + warp);
    }
    // q·scale, rounded to f32 once; rows past S_q and the pad columns 0
    const float* qh = q + (static_cast<size_t>(head) * s_q + q_row0) * d;
    const int wq = (d + 3) / 4 * (VEC ? 1 : 4);
    Walk p = walk(threadIdx.x, wq, C::kThreads);
    for (int i = threadIdx.x; i < C::kBQ * wq; i += C::kThreads, step(p, wq)) {
      if constexpr (VEC) {
        float4 x = p.row < q_rows ? *reinterpret_cast<const float4*>(qh + p.row * d + 4 * p.c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
        *reinterpret_cast<float4*>(sq + chunk_xor<DT>(p.row, 4 * p.c, q_xor<C::kRPW>(p.row))) = x;
      } else {
        sq[chunk_xor<DT>(p.row, p.c, q_xor<C::kRPW>(p.row))] =
            p.row < q_rows && p.c < d ? qh[p.row * d + p.c] * scale : 0.f;
      }
    }
    __syncthreads();
  }

  float o[R][NC][VW], m[R], lp[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    lp[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int w = 0; w < VW; ++w) o[i][cc][w] = 0.f;
    }
  }
  const int nch = (d + 3) / 4;  // 16-byte chunks of a q·k product
  const int qx = q_xor<C::kRPW>(tr), kx = tx & 7;
  const int pswz = tr * C::kKG;  // P keys xor'd by row group
  const float* qrow = sq + (wrow0 + tr) * DT;
  float* prow = sp + (wrow0 + tr) * kBK;
  const long long qi0 = static_cast<long long>(q_row0) + wrow0 + tr;

  for (int t = 0; t < live; ++t) {
    const int stage = t % NS, key0 = t * kBK;
    sm90::mbar_wait(full + stage, (t / NS) & 1);
    if (t < warp_live) {
      const float* ks = sk + stage * kBK * DT + K * tx * DT;
      const float* vs = sv + stage * kBK * DT + VW * tx;

      // S = (q·scale)·Kᵀ: an FMA chain over d for each score
      float s[R][K];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int e = 0; e < K; ++e) s[i][e] = 0.f;
      }
#pragma unroll 2
      for (int c = 0; c < nch; ++c) {
        float4 kf[K];
#pragma unroll
        for (int e = 0; e < K; ++e) kf[e] = lds4(ks + e * DT + ((c ^ kx) << 2));
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qf = lds4(qrow + C::kRPW * i * DT + ((c ^ qx) << 2));
#pragma unroll
          for (int e = 0; e < K; ++e) {
            s[i][e] = fmaf(qf.x, kf[e].x, s[i][e]);
            s[i][e] = fmaf(qf.y, kf[e].y, s[i][e]);
            s[i][e] = fmaf(qf.z, kf[e].z, s[i][e]);
            s[i][e] = fmaf(qf.w, kf[e].w, s[i][e]);
          }
        }
      }

      __syncwarp();  // the warp's P·V reads of the last tile are done
      const bool mask = key0 + kBK > s_k ||
                        (causal && static_cast<long long>(q_offset) + q_row0 + wrow0 <
                                       static_cast<long long>(k_offset) + key0 + kBK - 1);
      if (mask) {
        softmax_tile<DT, true>(s, m, lp, o, prow, pswz, tx, qi0, key0 + K * tx, s_k, causal,
                               q_offset, k_offset);
      } else {
        softmax_tile<DT, false>(s, m, lp, o, prow, pswz, tx, qi0, key0 + K * tx, s_k, causal,
                                q_offset, k_offset);
      }
      __syncwarp();  // a row's p come from the kKG lanes of its row group

      // O += P·V: an FMA chain over the tile's keys in order
#pragma unroll 2
      for (int j4 = 0; j4 < kBK; j4 += 4) {
        float4 pf[R];
#pragma unroll
        for (int i = 0; i < R; ++i) pf[i] = lds4(prow + C::kRPW * i * kBK + (j4 ^ pswz));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[NC][VW];
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const float* src = vs + (j4 + jj) * DT + C::kKG * VW * cc;
            if constexpr (VW == 4) {
              const float4 x = lds4(src);
              vv[cc][0] = x.x, vv[cc][1] = x.y, vv[cc][2] = x.z, vv[cc][3] = x.w;
            } else {
              const float2 x = *reinterpret_cast<const float2*>(src);
              vv[cc][0] = x.x, vv[cc][1] = x.y;
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float pj = lane_of(pf[i], jj);
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
              for (int w = 0; w < VW; ++w) o[i][cc][w] = fmaf(pj, vv[cc][w], o[i][cc][w]);
            }
          }
        }
      }
    }

    // done with the stage: the last warp to be done refills it
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = (atomicAdd(done + stage, 1) + 1) % C::kWarps == 0;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && t + NS < live) {
      __threadfence_block();
      const size_t off = static_cast<size_t>(key0 + NS * kBK) * d;
      const int rows = min(kBK, s_k - key0 - NS * kBK);
      copy_tile<DT, W, true>(sk + stage * kBK * DT, kh + off, rows, d, lane);
      copy_tile<DT, W, false>(sv + stage * kBK * DT, vh + off, rows, d, lane);
      arrive_on_copies(full + stage);
    }
  }

  // l: the kKG lanes' partial sums by a butterfly; out = o / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float l = lp[i];
#pragma unroll
    for (int x = 1; x < C::kKG; x <<= 1) l += __shfl_xor_sync(0xffffffffu, l, x);
    const int row = wrow0 + tr + C::kRPW * i;
    if (row >= q_rows) continue;
    const float den = fmaxf(l, 1e-30f);
    const size_t orow = static_cast<size_t>(head) * s_q + q_row0 + row;
    float* dst = out + orow * d;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = VW * tx + C::kKG * VW * cc;
      float y[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) y[w] = o[i][cc][w] / den;
      if constexpr (VEC && VW == 4) {
        if (col < d) *reinterpret_cast<float4*>(dst + col) = make_float4(y[0], y[1], y[2], y[3]);
      } else if constexpr (VEC) {
        if (col < d) *reinterpret_cast<float2*>(dst + col) = make_float2(y[0], y[1]);
      } else {
#pragma unroll
        for (int w = 0; w < VW; ++w) {
          if (col + w < d) dst[col + w] = y[w];
        }
      }
    }
    if (lse != nullptr && tx == 0) lse[orow] = m[i] + logf(den);
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

// Launches of the tiled kernel in this process (read by
// keystone_flash_attention_f32_tiled_launches).
std::atomic<long long> tiled_launches{0};

template <int DT, bool VEC>
int launch_tiled(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                 int s_q, int s_k, int d, int q_offset, int k_offset, int causal, float scale,
                 cudaStream_t s) {
  using C = Tiled<DT>;
  constexpr int smem = C::kSmemBytes;
  static bool configured[sm90::kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(configured, flash_fwd_f32<DT, VEC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(bh) * ((s_q + C::kBQ - 1) / C::kBQ);
  flash_fwd_f32<DT, VEC><<<blocks, C::kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, bh, s_q, s_k, d,
      q_offset, k_offset, causal, scale);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) tiled_launches.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int>(launched);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows 16-byte aligned: D % 4 == 0 and every base aligned.
bool rows_aligned(const void* q, const void* k, const void* v, const void* out, int d) {
  return d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

// D rounded up to the tiled kernel's DT: 32, 64 or 128; 128 for rows off
// 16 bytes.
int tiled_dt(int d, bool vec) { return !vec ? 128 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// S_k > 64: the tiled kernel.
int launch_f32_tiled(const void* q, const void* k, const void* v, void* out, float* lse,
                     int bh, int s_q, int s_k, int d, int q_offset, int k_offset, int causal,
                     float scale, cudaStream_t s) {
  if (!rows_aligned(q, k, v, out, d)) {
    return launch_tiled<128, false>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset, k_offset,
                                    causal, scale, s);
  }
  switch (tiled_dt(d, true)) {
    case 32:
      return launch_tiled<32, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset, k_offset,
                                    causal, scale, s);
    case 64:
      return launch_tiled<64, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset, k_offset,
                                    causal, scale, s);
    default:
      return launch_tiled<128, true>(q, k, v, out, lse, bh, s_q, s_k, d, q_offset, k_offset,
                                     causal, scale, s);
  }
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
    return launch_f32_tiled(q, k, v, out, l, bh, s_q, s_k, d, q_offset, k_offset,
                            causal, scale, s);
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
    switch (tiled_dt(d, vec)) {
      case 32:
        return Tiled<32>::kSmemBytes;
      case 64:
        return Tiled<64>::kSmemBytes;
      default:
        return Tiled<128>::kSmemBytes;
    }
  }
  const int dt = !vec ? 128 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  const int kmax = !vec ? 64 : s_k <= 16 ? 16 : s_k <= 32 ? 32 : 64;
  return short_plan(dt, kmax, bh, s_q, s_k).smem;
}

// The tiled f32 kernel's launches in this process so far: which route a
// caller's f32 calls took, beside the wrapper's count of both routes.
extern "C" long long keystone_flash_attention_f32_tiled_launches() {
  return tiled_launches.load();
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
