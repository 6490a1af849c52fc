// K4: the fused int8-dequant matmul of the LM decode path.
//
// Replaces keystone_tpu/ops/int8_matmul.py::mm_fused (Pallas kernel
// _kernel). Computes out = (y @ q) · scale: y (M, K) f32 or bf16,
// row-major; q (K, N) int8 codes, row-major; scale (1, N) f32; out (M, N)
// in y's dtype. The codes are widened after the load, the products are
// summed in f32, the scale is applied once to the sum, and the result is
// rounded once to y's dtype, as the TPU kernel does.
//
// What bounds it on an H100: bytes. A decode step has M = 8 rows, so the
// kernel does 2·M = 16 operations per weight byte, far below the ~295 the
// card needs before its tensor cores are the limit. The weights are read
// once as int8: K·N + 2·M·K + 4·N + 2·M·N bytes (1024 × 4096 in bf16:
// 4.2 MB, 1.25 µs at the H100 SXM datasheet's 3.35 TB/s). At that size the
// launch and every round trip to memory that one block waits for after
// another are of the same order as the stream itself, so the design keeps
// those chains short.
//
// Design: one launch; each column tile of 128 outputs is one thread block
// cluster whose blocks split the contraction.
//   - A cluster of S blocks covers one column tile; block s takes the
//     s-th of S equal runs of its 16-row code slabs. The wrapper picks S
//     (at most 8) from the card's SM count and the kernel's cluster
//     occupancy: 64 or 96 blocks at the decode shapes.
//   - In a block of 8 warps each warp streams every eighth slab of the
//     run: lane (g, t) takes code rows 2t, 2t+1, 2t+8, 2t+9 of the slab,
//     columns 16g..16g+15, as 16-byte loads (a warp's load covers four
//     whole 128-byte lines) into registers, and the slab's rows of y, in
//     y's own dtype, into a slot of shared memory by cp.async; two slabs
//     ahead. A warp waits for its own slab only, so the products of early
//     slabs run while the rest of the stream is on its way.
//   - bf16: a bf16 activation times an int8 code is exact in f32, and so
//     is the tensor cores' product of two bf16 values, so the products run
//     as mma.sync m16n8k16 bf16 → f32: the codes, widened to bf16 (exactly,
//     through the f32 bit pattern 2²³ + code + 128) and paired along k,
//     are the A operand over 16 columns, yᵀ the n8 operand over 8 rows.
//     Rows past 8 take a second n8 tile (16 rows a block; more rows, more
//     clusters along grid y).
//   - f32 stays on CUDA cores (an f32 product by a code is not exact in
//     bf16): FMAs into 4 rows × 16 columns a thread, lanes of one column
//     group summed by shuffles; 4 rows a block.
//   - The warps' partials are summed through shared memory in warp order;
//     block s then stores the r-th slice of its partial into block r's
//     shared memory (distributed shared memory) by st.async, counted on
//     block r's mbarrier, and each block sums its slice over the S blocks
//     as soon as they have landed, in block (that is, k) order, applies the
//     scales (read before the stream) and writes y's dtype. No workspace,
//     no atomics: the order of every sum is fixed, so the same inputs give
//     the same bits, eagerly or replayed in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;     // columns of a slab and of a column tile
constexpr int kSlab = 16;      // code rows of a slab
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 2;      // slabs a warp holds in flight
constexpr int kMaxSplits = 16;  // most blocks in a cluster
constexpr int kPitch = kCols + 4;  // row pitch (floats) of the warps' partials
constexpr int kMaxDevices = 64;

// How one launch cuts the work, as the wrapper plans it
// (ops/int8_matmul.py::k4_plan) and check_plan below verifies.
struct Plan {
  int rows;       // rows of y a block: 16 or 8 (bf16), 4 (f32)
  int groups;     // clusters along grid y: ⌈m / rows⌉
  int col_tiles;  // clusters along grid x: ⌈n / 128⌉
  int slabs;      // 16-row code slabs of a column tile: ⌈k / 16⌉
  int splits;     // blocks of a cluster: S
  int smem;       // dynamic shared memory of a block
};

// Blocks an SM holds: two with 8 rows of bf16 y (128 registers a thread),
// so that twice the clusters run at once; one otherwise.
template <typename T, int ROWS>
constexpr int blocks_per_sm() {
  return sizeof(T) == 2 && ROWS == 8 ? 2 : 1;
}

// the inbox: every block's slice of one tile's partial, ROWS · 128 / 4
// float4 (16 rows) rounded up to S slices
constexpr int kInbox = 16 * kCols / 4 + kMaxSplits;

// A slab's rows of y in shared memory: ROWS rows of 16 elements, rows
// 48 (bf16) or 80 (f32) bytes apart, so that a warp's fragment loads meet
// every bank once. Each warp has kDepth of them, one per slab in flight.
template <typename T>
__host__ __device__ constexpr int slot_pitch() {
  return sizeof(T) == 2 ? 24 : 20;
}

template <typename T, int ROWS>
constexpr int smem_bytes() {
  return kWarps * ROWS * kPitch * 4 + kInbox * 16 +
         kWarps * kDepth * ROWS * slot_pitch<T>() * static_cast<int>(sizeof(T));
}

bool check_plan(const Plan& p, int m, int k, int n, bool bf16) {
  const int rows = bf16 ? (m <= 8 ? 8 : 16) : 4;
  return p.rows == rows && p.groups == (m + rows - 1) / rows &&
         p.col_tiles == (n + kCols - 1) / kCols && p.slabs == (k + kSlab - 1) / kSlab &&
         p.splits >= 1 && p.splits <= kMaxSplits && p.splits <= p.slabs &&
         p.smem == (bf16 ? (rows == 8 ? smem_bytes<__nv_bfloat16, 8>()
                                      : smem_bytes<__nv_bfloat16, 16>())
                         : smem_bytes<float, 4>());
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
}

// Columns col .. col + 3 of row `row`: the sums s times their scales sc,
// in y's dtype; entries past m or n are not written.
template <typename T>
__device__ __forceinline__ void finish(T* out, float4 sc, float4 s, int row,
                                       int col, int m, int n) {
  if (row >= m) return;
  const float v[4] = {s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (col + x < n) store(out + static_cast<size_t>(row) * n + col + x, v[x]);
  }
}

// Code row r (0..3) of lane t's four rows of a unit: 2t, 2t+1, 2t+8, 2t+9
// (the rows of the mma fragments below).
__device__ __forceinline__ int unit_row(int r, int t) {
  return 2 * t + (r & 1) + 8 * (r >> 1);
}

// Lane (g, t)'s 4 × 16 codes of the unit at code row k0, column col.
// Rows past k and columns past n read as 0.
template <bool kVec>
__device__ __forceinline__ void load_unit(uint4 (&v)[4],
                                          const int8_t* __restrict__ q, int k,
                                          int n, int k0, int col, int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k0 + unit_row(r, t);
    const int8_t* src = q + static_cast<size_t>(kr) * n + col;
    if (kVec) {
      v[r] = (kr < k && col < n) ? __ldg(reinterpret_cast<const uint4*>(src))
                                 : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (kr < k) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (col + j < n) {
            w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j)))
                        << (8 * (j % 4));
          }
        }
      }
      v[r] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The four int8 codes of w as exact f32: the bit pattern 2²³ + (code +
// 128), less 2²³ + 128.
__device__ __forceinline__ void codes_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// w's codes (c0, c1, c2, c3) as two bf16 pairs (c0, c1) and (c2, c3): an
// integer of at most 8 bits is exact in bf16, so each half is the top of
// its f32.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& p01,
                                           uint32_t& p23) {
  float f[4];
  codes_f32(w, f);
  p01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  p23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 products of one unit. Lane (g, t) holds codes of rows 2t, 2t+1
// (v[0], v[1]) and 2t+8, 2t+9 (v[2], v[3]) in columns 16g..16g+15. mma j
// (0..7) takes column 16g + j as its A row g and 16g + 8 + j as its row
// g + 8, so acc[mt][j] holds rows 8·mt + 2t (+1) of y against columns
// 16g + j ([0], [1]) and 16g + 8 + j ([2], [3]).
template <int MT>
__device__ __forceinline__ void unit_bf16(const uint4 (&v)[4],
                                          const __nv_bfloat16* y_s, int g, int t,
                                          float (&acc)[MT][8][4]) {
  constexpr int stride = slot_pitch<__nv_bfloat16>();
  uint32_t lo[16], hi[16];  // per column: rows (2t, 2t+1), (2t+8, 2t+9)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p0, p1, p2, p3;
    codes_bf16(__byte_perm(word(v[0], i), word(v[1], i), 0x5140), p0, p1);
    codes_bf16(__byte_perm(word(v[0], i), word(v[1], i), 0x7362), p2, p3);
    lo[4 * i] = p0, lo[4 * i + 1] = p1, lo[4 * i + 2] = p2, lo[4 * i + 3] = p3;
    codes_bf16(__byte_perm(word(v[2], i), word(v[3], i), 0x5140), p0, p1);
    codes_bf16(__byte_perm(word(v[2], i), word(v[3], i), 0x7362), p2, p3);
    hi[4 * i] = p0, hi[4 * i + 1] = p1, hi[4 * i + 2] = p2, hi[4 * i + 3] = p3;
  }
  uint32_t b[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* row = y_s + (8 * mt + g) * stride + 2 * t;
    b[mt][0] = *reinterpret_cast<const uint32_t*>(row);
    b[mt][1] = *reinterpret_cast<const uint32_t*>(row + 8);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t a[4] = {lo[j], lo[8 + j], hi[j], hi[8 + j]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a, b[mt][0], b[mt][1]);
  }
}

// The f32 products of one unit on CUDA cores: acc[r][c] += y[r][row]·code
// over lane t's four code rows.
__device__ __forceinline__ void unit_f32(const uint4 (&v)[4], const float* y_s,
                                         int t, float (&acc)[4][16]) {
  constexpr int stride = slot_pitch<float>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float yv[4];
#pragma unroll
    for (int row = 0; row < 4; ++row) yv[row] = y_s[row * stride + unit_row(r, t)];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      codes_f32(word(v[r], i), f);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int row = 0; row < 4; ++row) {
          acc[row][4 * i + x] = fmaf(yv[row], f[x], acc[row][4 * i + x]);
        }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v into `dst` in the shared memory of cluster block `rank` (dst and bar
// name this block's copies of the same variables), counted as 16 bytes on
// that block's mbarrier `bar`.
__device__ __forceinline__ void send4(const float4* dst, uint64_t* bar, int rank,
                                      float4 v) {
  uint32_t rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(rdst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

// Wait for the first phase of `bar` to complete. A wait past 4 s traps, so
// a fault ends the launch with an error instead of holding the card.
__device__ __forceinline__ void wait_parity0(uint64_t* bar) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 4000000000ull) {
      asm volatile("trap;");
    }
  }
}

// Wait for this lane's cp.async groups but the `later` newest (0 or 1):
// the oldest of the two slabs in flight has landed.
__device__ __forceinline__ void wait_slab(int later) {
  static_assert(kDepth == 2, "two slabs in flight: one may still be on its way");
  if (later > 0) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows m0 .. m0 + ROWS − 1 of y, code rows k0 .. k0 + 15, into a warp's
// slot, zeros past m and k; one cp.async group per lane. kAsync: 16-byte
// cp.async pieces (y's rows 16-byte aligned, k a multiple of the piece);
// else plain loads and stores.
template <typename T, int ROWS, bool kAsync>
__device__ __forceinline__ void stage_slab(T* slot, const T* __restrict__ y, int m,
                                           int k, int m0, int k0, int lane) {
  constexpr int kStride = slot_pitch<T>();
  if (kAsync) {
    constexpr int kPer = 16 / sizeof(T);  // elements a piece
    constexpr int kPieces = ROWS * kSlab / kPer;
    for (int i = lane; i < kPieces; i += 32) {
      const int r = i / (kSlab / kPer), kk = (i % (kSlab / kPer)) * kPer;
      const int row = m0 + r, kg = k0 + kk;
      const bool live = row < m && kg < k;
      cp_async16(slot + r * kStride + kk,
                 live ? y + static_cast<size_t>(row) * k + kg : y, live ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = lane; i < ROWS * kSlab; i += 32) {
      const int r = i / kSlab, kk = i % kSlab;
      const int row = m0 + r, kg = k0 + kk;
      slot[r * kStride + kk] =
          (row < m && kg < k) ? y[static_cast<size_t>(row) * k + kg] : T(0.f);
    }
  }
}

// One block: slabs of split s (its rank in the cluster) of one column
// tile, for ROWS rows of y. T is y's dtype.
template <typename T, int ROWS, bool kVec, bool kAsync>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<T, ROWS>())
    int8_matmul_kernel(const T* __restrict__ y, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int m, int k, int n, const Plan p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int MT = kBf16 ? ROWS / 8 : 1;  // n8 tiles of y (bf16)
  constexpr int kQuads = ROWS * kCols / 4;
  extern __shared__ __align__(16) unsigned char k4_smem[];
  constexpr int kFinish = (kQuads + kThreads - 1) / kThreads;  // quads a thread ends
  float* red = reinterpret_cast<float*>(k4_smem);  // [warp][row][column]
  float4* inbox = reinterpret_cast<float4*>(k4_smem + kWarps * ROWS * kPitch * 4);
  T* y_s = reinterpret_cast<T*>(k4_smem + kWarps * ROWS * kPitch * 4 + kInbox * 16);

  __shared__ __align__(8) uint64_t inbox_full;  // counts the slices received
  const int s = static_cast<int>(cg::this_cluster().block_rank());
  const int slice = (kQuads + p.splits - 1) / p.splits;
  if (threadIdx.x == 0) {
    const int quads = min(kQuads, (s + 1) * slice) - s * slice;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&inbox_full)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(&inbox_full)),
                 "r"(p.splits * quads * 16)
                 : "memory");
  }
  // every block of the cluster must have started, and its mbarrier be
  // armed, before another writes into its shared memory: arrive now
  // (release), wait before the first such write (acquire)
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const int tile = blockIdx.x / p.splits, grp = blockIdx.y;
  const int m0 = grp * ROWS, c0 = tile * kCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = c0 + 16 * g;
  const int s_begin = static_cast<int>(static_cast<long long>(s) * p.slabs / p.splits);
  const int s_end = static_cast<int>(static_cast<long long>(s + 1) * p.slabs / p.splits);
  // the scales of the columns this block ends, read before the stream
  float4 sc[kFinish];
  {
    int i = s * slice + tid;
#pragma unroll
    for (int x = 0; x < kFinish; ++x, i += kThreads) {
      const int c = c0 + 4 * (i % (kCols / 4));
      sc[x] = make_float4(c < n ? scale[c] : 0.f, c + 1 < n ? scale[c + 1] : 0.f,
                          c + 2 < n ? scale[c + 2] : 0.f, c + 3 < n ? scale[c + 3] : 0.f);
    }
  }

  float acc_b[MT][8][4];
  float acc_f[4][16];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_b[mt][j][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc_f[r][c] = 0.f;

  // Each warp streams slabs s_begin + warp, + 8, ...: the codes into
  // registers and the slab's rows of y into one of its shared-memory
  // slots, two slabs ahead; it waits for its own slab only, so the
  // products of early slabs run while later ones are on their way.
  const int mine = (s_end - s_begin - warp + kWarps - 1) / kWarps;  // ≥ 0 slabs
  T* slots = y_s + warp * kDepth * ROWS * slot_pitch<T>();
  uint4 buf[kDepth][4];
  auto fetch = [&](int d, int i) {
    const int k0 = (s_begin + warp + i * kWarps) * kSlab;
    load_unit<kVec>(buf[d], q, k, n, k0, col, t);
    stage_slab<T, ROWS, kAsync>(slots + (i % kDepth) * ROWS * slot_pitch<T>(), y, m, k,
                                m0, k0, lane);
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < mine) fetch(d, d);
  }
#pragma unroll 1
  for (int i = 0; i < mine; ++i) {
    if (kAsync) wait_slab(min(kDepth - 1, mine - 1 - i));
    __syncwarp();
    const T* slot = slots + (i % kDepth) * ROWS * slot_pitch<T>();
    if constexpr (kBf16) {
      unit_bf16<MT>(buf[0], reinterpret_cast<const __nv_bfloat16*>(slot), g, t, acc_b);
    } else {
      unit_f32(buf[0], reinterpret_cast<const float*>(slot), t, acc_f);
    }
    __syncwarp();  // the slot is refilled below
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) buf[d][r] = buf[d + 1][r];
    if (i + kDepth < mine) fetch(kDepth - 1, i + kDepth);
  }

  // this warp's partial (ROWS × 128) into red[warp], rows kPitch floats
  // apart so that the 16-byte stores of a quarter warp meet at most two to
  // a bank. A lane holds rows 2t, 2t + 1 (+ 8·mt) of columns 16g .. 16g+15
  // across its eight accumulators: j for 16g + j, [2], [3] for 16g + 8 + j.
  float4* mine_red = reinterpret_cast<float4*>(red + warp * ROWS * kPitch);
  if constexpr (kBf16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* row = mine_red + (8 * mt + 2 * t + h) * (kPitch / 4) + 4 * g;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 4 * (x % 2), e = h + 2 * (x / 2);  // columns 4x .. 4x + 3
          row[x] = make_float4(acc_b[mt][j][e], acc_b[mt][j + 1][e], acc_b[mt][j + 2][e],
                               acc_b[mt][j + 3][e]);
        }
      }
  } else {
    // the four lanes of a column group hold other code rows: fold them
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float v = acc_f[r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        acc_f[r][c] = v;
      }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          mine_red[r * (kPitch / 4) + 4 * g + x] = make_float4(
              acc_f[r][4 * x], acc_f[r][4 * x + 1], acc_f[r][4 * x + 2], acc_f[r][4 * x + 3]);
        }
    }
  }
  __syncthreads();

  // The block's partial, warps in order, is cut into S slices; slice r
  // goes to block r's inbox (distributed shared memory) by st.async, each
  // store counted on block r's mbarrier; block r then sums its slice over
  // the S blocks, blocks in order. A block waits only for the slices sent
  // to it, and leaves only once they have all landed.
  const float4* red4 = reinterpret_cast<const float4*>(red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < kQuads; i += kThreads) {
    const int at = i / (kCols / 4) * (kPitch / 4) + i % (kCols / 4);
    float4 v = red4[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(v, red4[w * ROWS * (kPitch / 4) + at]);
    send4(inbox + s * slice + i % slice, &inbox_full, i / slice, v);
  }
  wait_parity0(&inbox_full);
  int i = s * slice + tid;
  for (int x = 0; x < kFinish; ++x, i += kThreads) {
    if (i < min(kQuads, (s + 1) * slice)) {
      float4 v = inbox[i - s * slice];
      for (int r = 1; r < p.splits; ++r) add4(v, inbox[r * slice + i - s * slice]);
      finish(out, sc[x], v, m0 + i / (kCols / 4), c0 + 4 * (i % (kCols / 4)), m, n);
    }
  }
}

template <typename T, int ROWS, bool kVec, bool kAsync>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && configured[dev])) return err;
  auto kernel = int8_matmul_kernel<T, ROWS, kVec, kAsync>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<T, ROWS>());
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return err;
}

// A launch of one cluster of `splits` blocks per column tile.
cudaLaunchConfig_t cluster_config(const Plan& p, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.col_tiles * p.splits, p.groups);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = p.smem;
  config.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T, int ROWS, bool kVec, bool kAsync>
int launch(const void* y, const void* q, const void* scale, void* out, int m,
           int k, int n, const Plan& p, cudaStream_t s) {
  cudaError_t err = configure<T, ROWS, kVec, kAsync>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(p, s, &attr);
  err = cudaLaunchKernelEx(&config, int8_matmul_kernel<T, ROWS, kVec, kAsync>,
                           static_cast<const T*>(y), static_cast<const int8_t*>(q),
                           static_cast<const float*>(scale), static_cast<T*>(out), m, k,
                           n, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `splits` blocks the current device runs at once.
template <typename T, int ROWS>
int clusters_at_once(int splits, int* out) {
  cudaError_t err = configure<T, ROWS, true, true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p{ROWS, 1, 1, splits, splits, smem_bytes<T, ROWS>()};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(p, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, int8_matmul_kernel<T, ROWS, true, true>, &config));
}

template <typename T, int ROWS>
int dispatch(const void* y, const void* q, const void* scale, void* out, int m,
             int k, int n, const Plan& p, cudaStream_t s) {
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool async = k % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    return async ? launch<T, ROWS, true, true>(y, q, scale, out, m, k, n, p, s)
                 : launch<T, ROWS, true, false>(y, q, scale, out, m, k, n, p, s);
  }
  return async ? launch<T, ROWS, false, true>(y, q, scale, out, m, k, n, p, s)
               : launch<T, ROWS, false, false>(y, q, scale, out, m, k, n, p, s);
}

}  // namespace

// out = (y @ q) · scale in one launch on `stream`. dtype: 0 = float32,
// 1 = bfloat16 (y and out). plan: the six fields of Plan, in order.
// Returns the launch's error (0 on success).
extern "C" int keystone_int8_matmul(const void* y, const void* q,
                                    const void* scale, void* out, int m, int k,
                                    int n, int dtype, const int* plan,
                                    void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  if (!check_plan(p, m, k, n, dtype == 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, 4>(y, q, scale, out, m, k, n, p, s);
  if (p.rows == 8) return dispatch<__nv_bfloat16, 8>(y, q, scale, out, m, k, n, p, s);
  return dispatch<__nv_bfloat16, 16>(y, q, scale, out, m, k, n, p, s);
}

// How many clusters of `splits` blocks (1 ≤ splits ≤ 16) the current
// device runs at once, for the kernel of dtype (0 = float32, 1 = bfloat16)
// and rows of y; the wrapper plans its splits by it.
extern "C" int keystone_int8_matmul_clusters(int dtype, int rows, int splits,
                                             int* out) {
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && rows == 4) return clusters_at_once<float, 4>(splits, out);
  if (dtype == 1 && rows == 8) return clusters_at_once<__nv_bfloat16, 8>(splits, out);
  if (dtype == 1 && rows == 16) return clusters_at_once<__nv_bfloat16, 16>(splits, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a K4 block with 8 and 16 rows of bf16 y and
// with 4 of f32, for the build report.
extern "C" int keystone_int8_matmul_smem_bytes(int variant) {
  return variant == 0 ? smem_bytes<float, 4>()
                      : variant == 8 ? smem_bytes<__nv_bfloat16, 8>()
                                     : smem_bytes<__nv_bfloat16, 16>();
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
