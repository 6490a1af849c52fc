// K1: the int8 Gram qᵀq for the streaming normal-equations fit.
//
// Replaces keystone_tpu/ops/gram.py::ata_int8_pallas (Pallas kernel
// _ata_kernel). Input: int8 codes q of shape (N, D), row-major. Output:
// out = qᵀq as f32 (D, D). The per-column scales are applied by the caller.
//
// Arithmetic: the JAX package's off-TPU form, ata_int8_xla, which contracts
// the codes exactly in int32 and rounds once to f32. Here each output entry
// is summed exactly in int32 over a segment of up to 131,072 rows (with
// |code| ≤ 127 the sum stays below 131,072·127² < 2³¹), converted to f32
// once, and segments are added in f32 in row order. A fit chunk is one
// segment, so the result is ata_int8_xla's qᵀq bit for bit, and (i, j)
// and (j, i) hold the same bits whichever tile computed them.
//
// What bounds it on an H100: int8 tensor-core operations. At the main
// path's chunk shape (N = 8,192, D = 16,384) the symmetric result's
// D(D+1)/2 distinct entries need N·D·(D+1) = 2.2e12 operations (1.1 ms at
// the 1,979 TOP/s datasheet peak) against N·D + 4·D² = 1.2 GB of traffic
// (0.36 ms at 3.35 TB/s). Only wgmma reaches that rate, and wgmma takes
// 8-bit operands from shared memory K-major only.
//
// Design:
//   1. A transposing pass writes qᵀ (D, Np), Np = N rounded up to 16 (TMA
//      needs 16-byte row pitches), with zeros past row N: a block moves a
//      128-row × 64-column tile through shared memory, 4×4 byte blocks
//      transposed in registers, 16-byte stores. About 2·N·D bytes of
//      traffic (0.08 ms at the main shape), counted in K1's time.
//   2. The Gram kernel: 128 × 256 output tiles, only those holding an entry
//      with i ≤ j (4,160 of 8,192 at D = 16,384), taken in the order of a
//      table the wrapper builds (bands of 8 column panels, so the panels
//      that run at once stay in L2), by a persistent grid of one block per
//      SM with a static stride. In a block a producer warp loads each
//      128-byte k-slab of the tile's A (128 rows) and B (256 rows) panels by
//      TMA (128-byte swizzle, out-of-range rows and columns read as zero)
//      into a 4-stage ring of 48 KB stages; where the A rows lie inside the
//      B panel only B is loaded. Two consumer warpgroups each run
//      wgmma m64n256k32 s8·s8→s32 from shared memory, 128 int32
//      accumulators a thread and no f32 copy, one commit group in flight
//      ahead of the stage they release.
//   3. The epilogue converts each accumulator to f32 once and writes entry
//      (i, j) where i ≤ j and its mirror (j, i) where i < j, so every entry
//      of out has exactly one writer. Tiles wholly above the diagonal
//      store without masks (8-byte row stores, 32-byte sector column
//      stores); tiles on the diagonal or the ragged edge test each entry.
//      Past the first segment the epilogue adds to out instead.
//
// Left for later: a 2-block cluster with TMA multicast of the shared B
// panel, and overlapping one tile's epilogue with the next tile's products.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sm90_common.cuh"

namespace {

using sm90::Desc;

constexpr int kBM = 128;  // output rows (i) a tile: two warpgroups of 64
constexpr int kBN = 256;  // output columns (j) a tile: one m64n256 wgmma
constexpr int kBK = 128;  // contraction bytes a stage: one swizzle span
constexpr int kStages = 4;
constexpr int kSegSteps = 131072 / kBK;  // stages of one int32 segment
constexpr int kBox = 128 * kBK;          // one 128-row TMA box: 16 KB
constexpr int kStageBytes = 3 * kBox;    // A, then B's two boxes
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + base alignment
constexpr int kThreads = 2 * 128 + 32;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------- transpose

constexpr int kTRows = 128;  // q rows (qᵀ columns) a transpose block
constexpr int kTCols = 64;   // q columns (qᵀ rows) a transpose block

// 4×4 byte transpose: on return w[x] holds column x's four rows (byte r =
// row r).
__device__ __forceinline__ void transpose_block(uint32_t (&w)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// qt (d, np) = qᵀ with zeros in columns n .. np − 1. Shared memory holds the
// tile column by column, 128 rows in eight 16-byte chunks, chunk c of column
// col at c ^ ((col / 4) % 8) so that both the transposed word stores and the
// 16-byte loads spread over the banks.
template <bool kVec>
__global__ void __launch_bounds__(256) transpose_kernel(
    const int8_t* __restrict__ q, int8_t* __restrict__ qt, int n, int d,
    int np) {
  __shared__ __align__(16) uint32_t t_s[kTCols * kTRows / 4];
  const int n0 = blockIdx.x * kTRows;
  const int d0 = blockIdx.y * kTCols;
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int blk = tid + 256 * it;
    const int cg = blk % 16, rg = blk / 16;  // columns 4cg.., rows 4rg..
    const int col = d0 + 4 * cg;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = n0 + 4 * rg + r;
      uint32_t v = 0;
      if (row < n) {
        const int8_t* p = q + static_cast<size_t>(row) * d + col;
        if (kVec) {
          if (col < d) v = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (col + x < d) {
              v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + x)))
                   << (8 * x);
            }
          }
        }
      }
      w[r] = v;
    }
    transpose_block(w);
    const int chunk = (rg / 4) ^ (cg % 8);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      t_s[(4 * cg + x) * 32 + chunk * 4 + rg % 4] = w[x];
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int blk = tid + 256 * it;
    const int c = blk / 8, ch = blk % 8;  // qᵀ row d0 + c, 16-byte chunk ch
    const int row = d0 + c, col = n0 + 16 * ch;
    if (row < d && col < np) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          &t_s[c * 32 + ((ch ^ ((c / 4) % 8)) * 4)]);
      *reinterpret_cast<uint4*>(qt + static_cast<size_t>(row) * np + col) = v;
    }
  }
}

// ---------------------------------------------------------- Gram

// acc (64 × 256, s32) += A · Bᵀ over 32 bytes of contraction; A and B
// K-major in shared memory, 128-byte swizzled.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void put(float* p, float v, bool accumulate) {
  if (accumulate) {
    *p += v;
  } else {
    *p = v;
  }
}

// One segment's accumulators into out. Thread (warp, g, t) of warpgroup wg
// holds element 4·c + e at row 64·wg + 16·warp + g + 8·(e / 2) and column
// 8·c + 2·t + e % 2 of the tile.
__device__ __forceinline__ void epilogue(const int (&acc)[128], float* out,
                                         int d, int2 tile, int wg, int warp,
                                         int g, int t, bool accumulate) {
  const int i0 = tile.x * kBM + 64 * wg + 16 * warp + g;
  const int j0 = tile.y * kBN + 2 * t;
  // every i below every j, every j inside d: no test, paired row stores
  const bool clear = !accumulate && tile.x * kBM + kBM <= tile.y * kBN &&
                     tile.y * kBN + kBN <= d && d % 2 == 0;
  if (clear) {
#pragma unroll
    for (int c = 0; c < 32; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h, j = j0 + 8 * c;
        const float v0 = __int2float_rn(acc[4 * c + 2 * h]);
        const float v1 = __int2float_rn(acc[4 * c + 2 * h + 1]);
        *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * d + j) =
            make_float2(v0, v1);
        out[static_cast<size_t>(j) * d + i] = v0;
        out[static_cast<size_t>(j + 1) * d + i] = v1;
      }
    return;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e / 2), j = j0 + 8 * c + e % 2;
      if (i < d && j < d) {
        const float v = __int2float_rn(acc[4 * c + e]);
        if (i <= j) put(out + static_cast<size_t>(i) * d + j, v, accumulate);
        if (i < j) put(out + static_cast<size_t>(j) * d + i, v, accumulate);
      }
    }
}

// A persistent block: tiles item = blockIdx.x, + gridDim.x, ... of the
// table, each over `steps` k-slabs of 128 bytes. The producer and the
// consumers walk the same tiles and slabs, so the ring's phases stay in
// step.
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(const __grid_constant__ CUtensorMap tq, float* __restrict__ out,
                const int2* __restrict__ tiles, int n_tiles, int d,
                int steps) {
  extern __shared__ __align__(16) unsigned char gram_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gram_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer
    if (threadIdx.x % 32 != 0) return;
    int gs = 0;  // slabs loaded so far, over all tiles
    for (int item = blockIdx.x; item < n_tiles; item += gridDim.x) {
      const int2 tile = tiles[item];
      const bool inside = tile.x / 2 == tile.y;  // A rows within B's panel
      for (int ks = 0; ks < steps; ++ks, ++gs) {
        const int stage = gs % kStages, round = gs / kStages;
        if (round > 0) sm90::mbar_wait(&empty[stage], (round - 1) & 1);
        unsigned char* st = smem + stage * kStageBytes;
        sm90::mbar_expect_tx(&full[stage], inside ? 2 * kBox : 3 * kBox);
        if (!inside) {
          sm90::tma_load_2d(st, &tq, &full[stage], ks * kBK, tile.x * kBM);
        }
        sm90::tma_load_2d(st + kBox, &tq, &full[stage], ks * kBK, tile.y * kBN);
        sm90::tma_load_2d(st + 2 * kBox, &tq, &full[stage], ks * kBK,
                          tile.y * kBN + 128);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const Desc db = sm90::desc_b128(smem + kBox, 16, 1024);
  int acc[128];
  int gs = 0;  // slabs consumed so far, over all tiles
  for (int item = blockIdx.x; item < n_tiles; item += gridDim.x) {
    const int2 tile = tiles[item];
    const bool inside = tile.x / 2 == tile.y;
    // this warpgroup's 64 rows of A: in A's box, or inside B's panel
    const int a_off = (inside ? kBox + (tile.x % 2) * kBox : 0) + 64 * wg * kBK;
    const Desc da = sm90::desc_b128(smem + a_off, 16, 1024);
    for (int seg0 = 0; seg0 == 0 || seg0 < steps; seg0 += kSegSteps) {
      const int seg1 = min(steps, seg0 + kSegSteps);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      for (int ks = seg0; ks < seg1; ++ks, ++gs) {
        const int stage = gs % kStages;
        sm90::mbar_wait(&full[stage], (gs / kStages) & 1);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        const uint32_t so = stage * kStageBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          wgmma_s8(acc, sm90::desc_at(da, so + 32 * kk),
                   sm90::desc_at(db, so + 32 * kk));
        }
        sm90::wgmma_commit();
        // the previous slab's products are done: release its stage
        sm90::wgmma_wait<1>();
        if (ks > seg0) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % kStages]);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (seg1 > seg0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[(gs - 1) % kStages]);
      }
      epilogue(acc, out, d, tile, wg, warp, g, t, seg0 > 0);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. q (n, d) int8 row-major; qt a scratch of
// d·np bytes (np = n rounded up to 16, at least 16), 16-byte aligned; out
// (d, d) f32; tiles the wrapper's table of n_tiles (I, J) tile pairs.
// Launches the transpose and the Gram kernel on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int keystone_int8_gram(const void* q, void* qt, void* out,
                                  const void* tiles, int n_tiles, long long n,
                                  long long d, long long np, void* stream) {
  if (n < 0 || d <= 0 || np < 16 || np % 16 != 0 || np < n || n_tiles <= 0 ||
      d > INT_MAX || np > INT_MAX || (d + kTCols - 1) / kTCols > 65535 ||
      reinterpret_cast<uintptr_t>(qt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid(static_cast<unsigned>((np + kTRows - 1) / kTRows),
                   static_cast<unsigned>((d + kTCols - 1) / kTCols));
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const auto* q8 = static_cast<const int8_t*>(q);
  auto* qt8 = static_cast<int8_t*>(qt);
  if (vec) {
    transpose_kernel<true><<<tgrid, 256, 0, s>>>(q8, qt8, static_cast<int>(n),
                                                 static_cast<int>(d),
                                                 static_cast<int>(np));
  } else {
    transpose_kernel<false><<<tgrid, 256, 0, s>>>(q8, qt8, static_cast<int>(n),
                                                  static_cast<int>(d),
                                                  static_cast<int>(np));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  sm90::EncodeTiled encode = nullptr;
  if ((err = sm90::encoder(&encode)) != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(np),
                              static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(np)};
  const cuuint32_t box[2] = {kBK, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qt, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);

  // the shared-memory opt-in and the SM count, once per device
  static bool configured[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(gram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) sms[dev] = n_sm;
  }
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  const int steps = static_cast<int>((n + kBK - 1) / kBK);
  gram_kernel<<<grid, kThreads, kSmem, s>>>(
      tq, static_cast<float*>(out), static_cast<const int2*>(tiles), n_tiles,
      static_cast<int>(d), steps);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the Gram kernel, for the build report.
extern "C" int keystone_int8_gram_smem_bytes() { return kSmem; }

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
