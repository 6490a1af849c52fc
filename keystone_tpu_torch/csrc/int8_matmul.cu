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
// 4.2 MB, 1.25 µs at the H100 SXM datasheet's 3.35 TB/s).
//
// Design (simple first version): a weight-streaming GEMV. A 256-thread
// block owns 128 output columns, up to 8 rows of y, and one slice of the
// contraction. Each thread reads 16 consecutive codes of one q row with a
// 16-byte load, widens them to f32 in registers and multiply-adds them
// against the block's rows of y, which sit in shared memory as f32. A
// bf16 activation times an int8 code is exact in f32, so the sums differ
// from the TPU kernel's only in their order. The 32 k-lanes of a block
// are summed with warp shuffles and then through shared memory, in a
// fixed order. 128 columns alone give only N/128 = 8–32 blocks for the
// decode widths, under a quarter of the 132 SMs, so the contraction is
// split across blocks into an f32 workspace (splits, M, N) and a second,
// small kernel sums the splits in order, applies the scale and writes y's
// dtype. No atomics: a run gives the same bits every time. Left for
// later: cp.async double buffering of the code stream and keeping the
// workspace in L2 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 128;                 // output columns per block
constexpr int kVec = 16;                   // codes per 16-byte load
constexpr int kColGroups = kCols / kVec;   // 8 threads cover the columns
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kColGroups;  // 32 k-lanes per block
constexpr int kRows = 8;                   // rows of y per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 512;             // most k-rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One (128-column, 8-row, k-slice) partial of y @ q into ws[split].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_partial(const T* __restrict__ y, const int8_t* __restrict__ q,
                        float* __restrict__ ws, int m, int k, int n,
                        int chunk, bool vec) {
  __shared__ float y_s[kRows][kMaxChunk];
  __shared__ float red[kWarps][kRows][kCols];

  const int col0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int k0 = split * chunk;
  const int k1 = min(k, k0 + chunk);
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * chunk; i += kThreads) {
    const int r = i / chunk, kk = i % chunk;
    const int row = row0 + r, kg = k0 + kk;
    y_s[r][kk] = (row < m && kg < k1)
                     ? to_f32(y[static_cast<size_t>(row) * k + kg])
                     : 0.f;
  }
  __syncthreads();

  const int g = tid % kColGroups;  // column group: 16 columns
  const int lane_k = tid / kColGroups;
  const int c0 = col0 + g * kVec;
  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;

  for (int kg = k0 + lane_k; kg < k1; kg += kLanes) {
    const int8_t* src = q + static_cast<size_t>(kg) * n + c0;
    int8_t codes[kVec];
    if (vec && c0 + kVec <= n) {
      const int4 word = *reinterpret_cast<const int4*>(src);
      const int8_t* b = reinterpret_cast<const int8_t*>(&word);
#pragma unroll
      for (int j = 0; j < kVec; ++j) codes[j] = b[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) codes[j] = (c0 + j < n) ? src[j] : 0;
    }
    float w[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) w[j] = static_cast<float>(codes[j]);
    const int kk = kg - k0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float yv = y_s[r][kk];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(yv, w[j], acc[r][j]);
    }
  }

  // the four k-lanes of a warp (lanes 8 apart) fold by shuffles, then the
  // eight warps through shared memory, always in the same order
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][j] = v;
    }
  const int warp = tid / 32;
  if ((tid % 32) < kColGroups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][r][g * kVec + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int row = row0 + r, col = col0 + c;
    if (row >= m || col >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) s += red[w8][r][c];
    ws[(static_cast<size_t>(split) * m + row) * n + col] = s;
  }
}

// out = (Σ_split ws[split]) · scale, summed in split order, in y's dtype.
template <typename T>
__global__ void int8_matmul_finish(const float* __restrict__ ws,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int m, int n,
                                   int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(m) * n;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[static_cast<size_t>(p) * total + i];
  store(out + i, s * scale[i % n]);
}

template <typename T>
int launch(const void* y, const void* q, const void* scale, void* ws,
           void* out, int m, int k, int n, int splits, int chunk,
           cudaStream_t s) {
  const bool vec = n % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((n + kCols - 1) / kCols, splits, (m + kRows - 1) / kRows);
  int8_matmul_partial<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const int8_t*>(q),
      static_cast<float*>(ws), m, k, n, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int8_matmul_finish<T><<<blocks, threads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<T*>(out), m, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (y and out). ws holds splits·m·n f32.
// The caller picks splits and chunk (chunk ≤ 512, splits·chunk ≥ k).
extern "C" int keystone_int8_matmul(const void* y, const void* q,
                                    const void* scale, void* ws, void* out,
                                    int m, int k, int n, int splits,
                                    int chunk, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || splits <= 0 || chunk <= 0 ||
      chunk > kMaxChunk ||
      static_cast<long long>(splits) * chunk < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(y, q, scale, ws, out, m, k, n, splits, chunk, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(y, q, scale, ws, out, m, k, n, splits,
                                 chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
