// The Hopper attention mainloop shared by K2 (flash_attention.cu) and K3
// (flash_attention_step.cu): the bf16 tile loop of an online softmax, on
// wgmma and TMA.
//
// A block holds 64·CONS q rows of one (b·h): CONS consumer warpgroups of 64
// rows each (three for K2 at D ≤ 64, two where the registers do not allow
// three) and one producer warp. The producer's first lane loads the Q tile
// once and the 64-key K/V tiles into a ring of kStages stages, all by
// TMA (cp.async.bulk.tensor), each completion counted on an mbarrier with
// expect-tx. Each consumer warpgroup, per K/V tile:
//
//   S = Q·Kᵀ         wgmma m64n64k16, both operands from shared memory;
//   mask, row max, p  in registers (the S accumulator), row max by quad
//                     shuffles;
//   O = O·alpha + P·V wgmma m64nDk16 with P as the register A operand and V
//                     read through the transpose bit (V stays keys × D).
//
// then releases the stage with one arrive per warp on its "empty" barrier.
// Within a warpgroup, S of tile t and P·V of tile t − 1 are issued
// together, so the softmax of t runs while P·V of t − 1 is on the tensor
// cores. The grid is persistent, one block per multiprocessor; blocks take
// (b·h, q tile) items from a counter, in sections whose K/V fit in L2
// together, heaviest causal tile first. Q is double-buffered, so the next
// item's Q and K/V load while the current one finishes and writes its
// result with 16-byte stores.
//
// Layout. Every tile is stored in 64-column panels of 128-byte rows, written
// by TMA with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands
// at chunk c ^ (r % 8). A D = 64 bf16 row is exactly one 128-byte swizzle
// span; D = 128 takes two panels. The wgmma descriptors name the same
// layout (type B128), with tile bases 1024-byte aligned so that the
// hardware's XOR of address bits [4:6] with [7:9] is the row's:
//   - Q, K (K-major): SBO = 1024 bytes between 8-row groups, LBO unused;
//     the k-th 16-column step adds 32·k bytes inside a panel;
//   - V (MN-major, transposed B): SBO = 1024 bytes between 8-key groups,
//     LBO = one panel between 64-column halves of D; the k-th 16-key step
//     adds 2,048 bytes.
// The S accumulator of two neighbouring 8-column groups, packed to bf16
// pairs, is exactly the A fragment of one k16 step, so P never leaves
// registers.
//
// Semantics (both TPU kernels'): begin-aligned causal positions at q_offset
// and k_offset; keys at or past S_k masked (TMA fills them with zeros, the
// mask sets their score to −1e30 and their p to exactly 0); causal tiles
// wholly past a warpgroup's last row are skipped. A row with no live key in
// a tile keeps m, l and acc bit for bit (alpha is exactly 1 when m does not
// move).
//
// The State policy (one per kernel) gives the number of P passes (1 for K2,
// p rounded to bf16; 3 for K3, p split exactly into bf16 hi + mid + lo),
// whether q is scaled in place before the product (K2) or s after it (K3),
// and how the (m, l, acc) state is read at the start and written at the end.
//
// Exponentials are ex2.approx on log2(e)-scaled differences: 2 ulp of f32,
// far inside K2's bf16 and K3's 1e-5 tolerances.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_common.cuh"

namespace sm90 {

constexpr int kBK = 64;  // keys per K/V tile
constexpr int kStages = 4;  // K/V ring depth: two tiles in use, two ahead
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Consumer warpgroups of 64 q rows a block: three where 128 registers a
// thread suffice (K2 at D ≤ 64), else two.
template <int DMAX, class State>
constexpr int consumers() {
  return State::kPasses == 1 && DMAX == 64 ? 3 : 2;
}

// The consumers and one producer warp. ptxas gives each thread what the
// register file allows the block: 128 for three consumers, 168 for two.
template <int CONS>
constexpr int threads() {
  return 128 * CONS + 32;
}

template <int DMAX, int CONS>
struct Smem {
  static constexpr int kBQ = 64 * CONS;  // q rows per block
  static constexpr int kPanels = DMAX / 64;
  static constexpr int kQPanel = kBQ * 128;  // bytes of one Q panel
  static constexpr int kKVPanel = kBK * 128;  // bytes of one K or V panel
  static constexpr int kQ = kQPanel * kPanels;  // Q buffer b at b·kQ
  static constexpr int kKV = kKVPanel * kPanels;
  static constexpr int kK0 = 2 * kQ;  // K of stage s at kK0 + s·kKV
  static constexpr int kV0 = kK0 + kStages * kKV;
  // q_full[2], q_empty[2], full[kStages], empty[kStages]
  static constexpr int kBar = kV0 + kStages * kKV;
  static constexpr int kItem = kBar + 8 * (4 + 2 * kStages);  // int[2]
  // + 1,024 so the base can be rounded up to the swizzle's alignment
  static constexpr int kBytes = kItem + 8 + 1024;
};

struct Shape {
  int s_q, s_k, d, q_tiles, bh, q_offset, k_offset, causal;
  float scale;  // K2: q·scale rounded to bf16; K3: s·scale in f32
  int group;  // b·h per L2 section (set by launch)
  // two int32, zero at launch: the next item to take and the blocks done
  // taking; the last block resets both for the next launch
  int* sched;
};

// S (64 × N) += A · Bᵀ, A and B K-major in shared memory. scale_d = 0
// overwrites S instead of adding.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

// O (64 × N) += A · B, A from registers, B MN-major (transposed) in shared
// memory. scale_d = 0 overwrites O instead of adding.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x cut to its top 16 bits: a bf16 value, exactly as wide as x's sign,
// exponent and first 7 significand bits; x − bf16_cut(x) is exact in f32.
__device__ __forceinline__ float bf16_cut(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// bf16_cut(lo) and bf16_cut(hi) as one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16_cut(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <class T>
__device__ __forceinline__ T sel4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Within each quad of lanes (t = lane % 4), x[q] of thread t becomes x[t]
// of thread q, by three XOR shuffles. An accumulator row holds in thread t
// the column pair 2·t of each 8-column group; after this, thread t holds
// the four pairs of group t, a whole 8-column chunk for one vector store.
// The same exchange turns loaded chunks back into accumulator pairs. Every
// lane of the warp must take part.
__device__ __forceinline__ void quad_transpose(float2 (&x)[4], int t) {
  float2 recv[4];
  recv[0] = sel4(x, t);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const float2 send = sel4(x, t ^ k);
    recv[k].x = __shfl_xor_sync(0xffffffffu, send.x, k);
    recv[k].y = __shfl_xor_sync(0xffffffffu, send.y, k);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) x[p] = sel4(recv, p ^ t);
}

// The row pairs of accumulator groups 4·j .. 4·j + 3 (times `scale`), as
// thread t's 8-column chunk 4·j + t: x[p] holds columns 8·(4j + t) + 2p, +1.
template <int N>
__device__ __forceinline__ void row_chunk(const float (&o)[N], int r, int j,
                                          int t, float scale, float2 (&x)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[q] = make_float2(o[4 * (4 * j + q) + 2 * r] * scale,
                       o[4 * (4 * j + q) + 2 * r + 1] * scale);
  }
  quad_transpose(x, t);
}

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// Key tiles a q window ending before row `row_end` can see: causal tiles
// wholly past its last position are skipped (exact: a fully masked tile
// leaves the state unchanged).
__device__ __forceinline__ int live_tiles(const Shape& sh, int row_end) {
  const int num_k = (sh.s_k + kBK - 1) / kBK;
  if (!sh.causal) return num_k;
  const long long span =
      static_cast<long long>(sh.q_offset) + row_end - sh.k_offset;
  if (span <= 0) return 0;
  const long long live = (span + kBK - 1) / kBK;
  return live < num_k ? static_cast<int>(live) : num_k;
}

// Items are (b·h, 64·CONS q rows) pairs, numbered section by section (b·h
// whose K/V fit in L2 together), heaviest causal q tile first within a
// section. Persistent blocks take them in that order from a counter in
// device memory, so a block that finishes early takes the next one.
__device__ __forceinline__ void coords(const Shape& sh, int item, int bq,
                                       int* bh, int* q_row0) {
  const int per_section = sh.group * sh.q_tiles;
  const int section = item / per_section;
  const int in_sec = item % per_section;
  const int width = min(sh.group, sh.bh - section * sh.group);
  *bh = section * sh.group + in_sec % width;
  *q_row0 = (sh.q_tiles - 1 - in_sec / width) * bq;
}

// A persistent block: one per multiprocessor, taking items from the
// counter. Its producer takes each item and hands it to the consumers in
// shared memory with that item's Q (the Q barrier's arrive releases it,
// their wait acquires it); item −1 ends the walk. State::kPasses is 1 or 3;
// State::kScaleQ says whether q·scale is rounded to bf16 in shared memory
// before the product (else s is scaled in f32 after it). Both sides count
// the same items and tiles, so the barriers' phases stay in step.
template <int DMAX, int CONS, class State>
__global__ void __launch_bounds__(threads<CONS>(), 1)
    attention_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Shape sh,
                     const State st) {
  using L = Smem<DMAX, CONS>;
  constexpr int kBQ = L::kBQ;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(attn_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  volatile int* item_s = reinterpret_cast<int*>(smem + L::kItem);  // per Q buffer

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4 * CONS);  // one arrive per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // ------------------------------------------------------ producer
    // one thread issues every load
    if (threadIdx.x % 32 != 0) return;
    int tile = 0;  // K/V tiles loaded so far, over all items
    const int items = sh.bh * sh.q_tiles;
    for (int n = 0;; ++n) {  // item n uses Q buffer n % 2
      int item = atomicAdd(&sh.sched[0], 1);
      if (item >= items) item = -1;
      const int qb = n & 1;
      if (n >= 2) mbar_wait(&q_empty[qb], ((n >> 1) - 1) & 1);
      item_s[qb] = item;
      if (item < 0) {
        mbar_arrive(&q_full[qb]);
        break;
      }
      int bh, q_row0;
      coords(sh, item, kBQ, &bh, &q_row0);
      // rows past S_q are padding: they need no key tile
      const int live_block = live_tiles(sh, min(q_row0 + kBQ, sh.s_q));
      if (live_block > 0) {
        mbar_expect_tx(&q_full[qb], L::kQ);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(smem + qb * L::kQ + p * L::kQPanel, &tq, &q_full[qb], 64 * p, q_row0, bh);
        }
      } else {
        mbar_arrive(&q_full[qb]);  // nothing to load: complete the phase
      }
      for (int kt = 0; kt < live_block; ++kt) {
        const int gt = tile + kt;
        const int stage = gt % kStages, round = gt / kStages;
        if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
        mbar_expect_tx(&full[stage], 2 * L::kKV);
        unsigned char* k_s = smem + L::kK0 + stage * L::kKV;
        unsigned char* v_s = smem + L::kV0 + stage * L::kKV;
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(k_s + p * L::kKVPanel, &tk, &full[stage], 64 * p, kt * kBK, bh);
          tma_load_3d(v_s + p * L::kKVPanel, &tv, &full[stage], 64 * p, kt * kBK, bh);
        }
      }
      tile += live_block;
    }
    // the last block to stop taking items resets the counter
    if (atomicAdd(&sh.sched[1], 1) == static_cast<int>(gridDim.x) - 1) {
      sh.sched[0] = 0;
      sh.sched[1] = 0;
    }
    return;
  }

  // -------------------------------------------------------- consumers
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the item's b·h, its first row for this warpgroup, and this thread's
  // rows: accumulator element 4·i + e sits at row row[e / 2], column
  // 8·i + 2·t + e % 2
  int bh = 0, wg_row0 = 0;
  int row[2];

  float m[2], l[2], o[DMAX / 2];

  // the operands' descriptors at their first tiles; each product adds its
  // tile's offset (and Q its buffer's)
  const Desc dq = desc_b128(smem + 64 * wg * 128, 16, 1024);
  const Desc dk = desc_b128(smem + L::kK0, 16, 1024);
  const Desc dv = desc_b128(smem + L::kV0, L::kKVPanel, 1024);
  uint32_t q_off = 0;  // the current item's Q buffer

  // S = Q·Kᵀ of global tile gt into s, asynchronously (one commit group)
  float s[32];
  auto issue_s = [&](int gt) {
    const uint32_t k_off = (gt % kStages) * L::kKV;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int p = j / 4, kb = 32 * (j % 4);
      wgmma_ss<64>(s, desc_at(dq, q_off + p * L::kQPanel + kb),
                   desc_at(dk, k_off + p * L::kKVPanel + kb), j > 0);
    }
    wgmma_commit();
  };

  // P·V of global tile gt from the A fragments, asynchronously. K3 splits
  // p exactly into three bf16 parts (hi, mid, lo), one pass each, and at
  // D = 64 takes the tile's P·V in an accumulator of its own (ot), added to
  // the carried acc in f32 once it is complete: small products summed into
  // a large acc inside the tensor cores lose low bits (8e-6 of max|acc|
  // against 9.6e-7 this way, at the ring's hop shape on an H100); at
  // D = 128 the registers hold no second accumulator. K2 rounds p once and
  // accumulates into o directly.
  constexpr bool kFresh = State::kPasses == 3 && DMAX == 64;
  uint32_t a[State::kPasses][4][4];
  float ot[kFresh ? DMAX / 2 : 1];
  auto issue_pv = [&](int gt) {
    const uint32_t v_off = (gt % kStages) * L::kKV;
#pragma unroll
    for (int pass = 0; pass < State::kPasses; ++pass)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc_at(dv, v_off + kk * 16 * 128);
        if constexpr (kFresh) {
          wgmma_rs_tb<DMAX>(ot, a[pass][kk], d, pass + kk > 0);
        } else {
          wgmma_rs_tb<DMAX>(o, a[pass][kk], d, 1);
        }
      }
    wgmma_commit();
  };

  // The online softmax of tile kt on s (scores in, p out): mask, row max,
  // m, l; alpha per row. o is not touched: P·V of the previous tile may
  // still be accumulating into it. Masking is compiled only into the
  // variant for tiles that cross S_k or the causal diagonal; there key
  // 8·i + e % 2 (past this thread's column base) is valid when it is at
  // most bound[row].
  float alpha[2];
  auto softmax_body = [&](auto masked, int kt) {
    constexpr bool kMasked = decltype(masked)::value;
    int bound[2];
    if (kMasked) {
      const long long col0 = static_cast<long long>(kt) * kBK + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        long long last = sh.s_k - 1;  // the last valid key of this row
        if (sh.causal) {
          const long long c = static_cast<long long>(sh.q_offset) + row[r] - sh.k_offset;
          last = c < last ? c : last;
        }
        const long long rel = last - col0;
        bound[r] = static_cast<int>(rel < -1 ? -1 : rel > kBK ? kBK : rel);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = State::kScaleQ ? s[4 * i + e] : s[4 * i + e] * sh.scale;
        if (kMasked && 8 * i + (e & 1) > bound[e >> 1]) x = kNeg;
        s[4 * i + e] = x;
      }
    // row max as a tree (max is exact in any order): 4 steps, not 16
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
      }
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
      mx[r] = fmaxf(v[0], kNeg);
    }
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m_new == m[r] ? 1.f : ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // K2 rounds p to bf16 anyway: one FFMA for the exponent. K3 keeps
        // f32 p: the difference first, then the scaling.
        const float x = s[4 * i + e];
        float p = State::kPasses == 1 ? ex2(fmaf(x, kLog2e, -ml[e >> 1]))
                                      : ex2((x - m[e >> 1]) * kLog2e);
        if (kMasked && 8 * i + (e & 1) > bound[e >> 1]) p = 0.f;
        s[4 * i + e] = p;
      }
    // row sums as a tree
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = s[4 * i + 2 * r] + s[4 * i + 2 * r + 1];
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] += v[i + w];
      l[r] = l[r] * alpha[r] + v[0];
    }
  };
  auto softmax = [&](int kt) {
    const int key0 = kt * kBK;
    const bool ragged = key0 + kBK > sh.s_k;
    const bool diag = sh.causal && static_cast<long long>(sh.k_offset) + key0 + kBK - 1 >
                                       static_cast<long long>(sh.q_offset) + wg_row0;
    if (ragged || diag) {
      softmax_body(Bool<true>{}, kt);
    } else {
      softmax_body(Bool<false>{}, kt);
    }
  };

  // the accumulators the P·V wgmma writes, ordered after its wait
  auto fence_acc = [&]() {
    fence_regs(o);
    if constexpr (kFresh) fence_regs(ot);
  };

  // K3: acc = acc·alpha + the tile's P·V, the alpha of that tile, in f32;
  // exact when no key of the tile was live (alpha 1, P·V 0)
  float alpha_pv[2];  // the alpha of the tile whose P·V is in ot
  auto add_tile = [&]() {
    if constexpr (kFresh) {
#pragma unroll
      for (int i = 0; i < DMAX / 8; ++i) {
        o[4 * i + 0] = fmaf(o[4 * i + 0], alpha_pv[0], ot[4 * i + 0]);
        o[4 * i + 1] = fmaf(o[4 * i + 1], alpha_pv[0], ot[4 * i + 1]);
        o[4 * i + 2] = fmaf(o[4 * i + 2], alpha_pv[1], ot[4 * i + 2]);
        o[4 * i + 3] = fmaf(o[4 * i + 3], alpha_pv[1], ot[4 * i + 3]);
      }
    }
  };

  // o·alpha (K3: the previous tile's P·V added), then p into the A
  // fragments: the S accumulator of groups
  // 2·kk and 2·kk + 1 is the A fragment of key step kk. K2 rounds p to
  // bf16 to nearest (its contract). K3 splits the f32 p exactly: hi, mid
  // and lo are each cut to a bf16 from what the parts before left, 3 × 8
  // significand bits for p's 24; cutting is bit masks and byte permutes,
  // where rounding would take the conversion unit, which the exponentials
  // already keep busy.
  auto rescale_pack = [&](bool pv_done) {
    if constexpr (kFresh) {
      if (pv_done) add_tile();
      alpha_pv[0] = alpha[0];
      alpha_pv[1] = alpha[1];
    } else if (alpha[0] != 1.f || alpha[1] != 1.f) {  // ·1 is exact: skip it
#pragma unroll
      for (int i = 0; i < DMAX / 8; ++i) {
        o[4 * i + 0] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // x: (group 2kk, row 0), (2kk, row 1), (2kk+1, row 0), (2kk+1, row 1)
        const int base = 4 * (2 * kk + x / 2) + 2 * (x % 2);
        float p0 = s[base], p1 = s[base + 1];
        if (State::kPasses == 1) {
          a[0][kk][x] = pack_bf16(p0, p1);
        } else {
#pragma unroll
          for (int pass = 0; pass < State::kPasses; ++pass) {
            a[pass][kk][x] = pack_bf16_cut(p0, p1);
            p0 -= bf16_cut(p0);
            p1 -= bf16_cut(p1);
          }
        }
      }
  };

  // release a stage: this warp's wgmmas on it have completed
  auto release = [&](int gt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[gt % kStages]);
  };

  // The pipeline within a warpgroup: for K2, S of tile kt and P·V of tile
  // kt − 1 are issued together, and the softmax of kt runs while P·V of
  // kt − 1 is on the tensor cores. K3's three P fragments and second
  // accumulator do not fit the 168 registers a thread of 384 has beside S
  // in flight (ptxas spills): there P·V of kt − 1 completes before S of kt
  // is issued.
  constexpr bool kOverlap = State::kPasses == 1;
  int tile = 0;  // K/V tiles consumed so far, over all items
  for (int n = 0;; ++n) {
    const int qb = n & 1;
    // every warp waits for every Q, used or not, so no wait ever runs a
    // phase ahead of its barrier
    mbar_wait(&q_full[qb], (n >> 1) & 1);
    const int item = item_s[qb];
    if (item < 0) break;
    int q_row0;
    coords(sh, item, kBQ, &bh, &q_row0);
    const int live_block = live_tiles(sh, min(q_row0 + kBQ, sh.s_q));
    wg_row0 = q_row0 + 64 * wg;
    const int live = wg_row0 < sh.s_q ? live_tiles(sh, min(wg_row0 + 64, sh.s_q)) : 0;
    row[0] = wg_row0 + 16 * warp + g;
    row[1] = row[0] + 8;
    st.load(sh, bh, row, t, m, l, o);

    q_off = qb * L::kQ;
    if (State::kScaleQ && live > 0) {
      // q·scale rounded to bf16, in place: elementwise, so the swizzle does
      // not matter; then make the generic-proxy writes visible to wgmma
      // (and ordered before the TMA that later refills the buffer)
      constexpr int kChunks = 64 * L::kPanels * 8;  // 16-byte chunks of 64 rows
#pragma unroll
      for (int i = tid; i < kChunks; i += 128) {
        const int p = i / 512, rr = (i % 512) / 8, c = i % 8;
        uint4* ptr = reinterpret_cast<uint4*>(smem + q_off + p * L::kQPanel +
                                              (64 * wg + rr) * 128 + 16 * c);
        uint4 w = *ptr;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 f = __bfloat1622float2(h[x]);
          h[x] = __floats2bfloat162_rn(f.x * sh.scale, f.y * sh.scale);
        }
        *ptr = w;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    if (live > 0) {
      mbar_wait(&full[tile % kStages], (tile / kStages) & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;  // overwritten: scale_d = 0 first
      wgmma_fence();
      issue_s(tile);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      rescale_pack(false);
      for (int kt = 1; kt < live; ++kt) {
        const int gt = tile + kt;
        mbar_wait(&full[gt % kStages], (gt / kStages) & 1);
        if (kOverlap) {
          fence_acc();
          wgmma_fence();
          issue_s(gt);
          issue_pv(gt - 1);
          wgmma_wait<1>();
          fence_regs(s);
          softmax(kt);
          wgmma_wait<0>();
          fence_acc();
          release(gt - 1);
        } else {
          fence_acc();
          wgmma_fence();
          issue_pv(gt - 1);
          wgmma_wait<0>();
          fence_acc();
          release(gt - 1);
          wgmma_fence();
          issue_s(gt);
          wgmma_wait<0>();
          fence_regs(s);
          softmax(kt);
        }
        rescale_pack(true);
      }
      fence_acc();
      wgmma_fence();
      issue_pv(tile + live - 1);
      wgmma_wait<0>();
      fence_acc();
      if (kFresh) add_tile();
      release(tile + live - 1);
    }
    // tiles only the other warpgroups see: wait for each load, then release
    for (int kt = live; kt < live_block; ++kt) {
      mbar_wait(&full[(tile + kt) % kStages], ((tile + kt) / kStages) & 1);
      release(tile + kt);
    }
    tile += live_block;
    // every wgmma that read this Q buffer has completed
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
    st.store(sh, bh, row, t, m, l, o);
  }
}

// ---------------------------------------------------------------- host

// A (BH, rows, d_in) bf16 tensor, row-major, as 64-column × box_rows boxes
// swizzled 128B; columns past d_in and rows past `rows` read as zeros.
// d_in must be a multiple of 8 (16-byte rows) and the base 16-byte aligned.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int bh,
                              int rows, int d_in, int box_rows) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  if (d_in % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const int r = rows > 0 ? rows : 1;  // an empty K/V block is never read
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d_in),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d_in) * 2,
                                 static_cast<cuuint64_t>(d_in) * 2 * r};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Dynamic shared memory of the kernel that launch<DMAX, State> starts.
template <int DMAX, class State>
constexpr int smem_bytes() {
  return Smem<DMAX, consumers<DMAX, State>()>::kBytes;
}

// Launch attention_kernel<DMAX, State>, persistent over bh · ⌈s_q / BQ⌉
// items; sh.sched points at the two zeroed int32 the blocks take items
// from (the wrapper keeps one pair per device and stream). q, k,
// v are (BH, S, d_in) bf16 with d_in a multiple of 8 (zero-padded by the
// wrapper where D is not).
template <int DMAX, class State>
int launch(const void* q, const void* k, const void* v, int d_in, Shape sh,
           const State& st, cudaStream_t stream) {
  constexpr int kCons = consumers<DMAX, State>();
  constexpr int kBQ = Smem<DMAX, kCons>::kBQ;
  constexpr int smem = Smem<DMAX, kCons>::kBytes;
  auto kernel = attention_kernel<DMAX, kCons, State>;
  // the shared-memory opt-in is per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  CUtensorMap tq, tk, tv;
  const void* kv_q = sh.s_k > 0 ? k : q;  // an empty block: never read
  const void* kv_v = sh.s_k > 0 ? v : q;
  const int kv_rows = sh.s_k > 0 ? sh.s_k : sh.s_q;
  if ((err = tensor_map(&tq, q, sh.bh, sh.s_q, d_in, kBQ)) != cudaSuccess ||
      (err = tensor_map(&tk, kv_q, sh.bh, kv_rows, d_in, kBK)) != cudaSuccess ||
      (err = tensor_map(&tv, kv_v, sh.bh, kv_rows, d_in, kBK)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  sh.q_tiles = (sh.s_q + kBQ - 1) / kBQ;
  // K and V of a section's b·h together take at most 16 MB of the 50 MB L2
  const long long kv_bytes = 4LL * kv_rows * d_in;
  const long long group = (16LL << 20) / (kv_bytes > 0 ? kv_bytes : 1);
  sh.group = static_cast<int>(group < 1 ? 1 : group > sh.bh ? sh.bh : group);
  // persistent: one block per multiprocessor, or one per item if fewer
  static int sms[kMaxDevices] = {};
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) sms[dev] = n_sm;
  }
  const long long items = static_cast<long long>(sh.bh) * sh.q_tiles;
  const unsigned grid = static_cast<unsigned>(items < n_sm ? items : n_sm);
  kernel<<<grid, threads<kCons>(), smem, stream>>>(tq, tk, tv, sh, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
