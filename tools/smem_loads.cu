// Shared-memory load throughput on the card by access pattern: what a warp's
// 16-byte (and 4-byte) shared load costs in SM clocks when its lanes read one
// address, a few or many. Each of 16 warps a block, one block an SM, runs
// loads of one pattern in a loop and adds the values, so that the loads are
// not removed; the SM clocks over the loop are divided by the loads issued.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o smem_loads smem_loads.cu
//   ./smem_loads
//
// On an NVIDIA H100 80GB HBM3 at 700 W a 16-byte load took about 2.4 clocks
// when each quarter-warp read at most four addresses and 4 when it read eight;
// the tiled f32 attention kernel (flash_attention.cu) is blocked by that.
#include <cstdio>

#include <cuda_runtime.h>

constexpr int kFloats = 8192;  // 32 KB of shared memory
constexpr int kWarps = 16;
constexpr int kIters = 2000;

// The float offset lane `lane` reads under pattern `mode`.
__device__ int offset(int mode, int lane) {
  switch (mode) {
    case 0: return 0;                                 // one address
    case 1: return lane / 16 * 4;                     // a half-warp one address
    case 2: return lane / 8 * 4;                      // a quarter-warp one address
    case 3: return lane / 4 * 4;                      // 2 addresses a quarter
    case 4: return lane / 2 * 4;                      // 4 addresses a quarter
    case 5: return lane % 8 * 4;                      // 8 a quarter, quarters alike
    case 6: return lane % 16 * 4;                     // 16 addresses, halves alike
    case 7: return lane * 4;                          // 32 addresses
    case 8: return lane;                              // 4-byte loads, 32 words
    default: return lane / 16;                        // 4-byte loads, 2 words
  }
}

__global__ void loads(int mode, float* out, long long* clocks) {
  __shared__ __align__(16) float sm[kFloats];
  for (int i = threadIdx.x; i < kFloats; i += blockDim.x) sm[i] = i * 1e-7f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int off = offset(mode, lane) + warp * 256;
  const bool wide = mode < 8;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
    const int o = off + ((it & 7) << 5);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int at = (o + u * 512) & (kFloats - 1);  // multiples of 32 keep the banks
      if (wide) {
        const float4 x = *reinterpret_cast<const float4*>(sm + at);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      } else {
        acc.x += sm[at];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) clocks[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

int main() {
  const char* names[] = {
      "16-byte, one address",          "16-byte, a half-warp one address",
      "16-byte, a quarter one address", "16-byte, 2 addresses a quarter",
      "16-byte, 4 addresses a quarter", "16-byte, 8 a quarter, quarters alike",
      "16-byte, 16 addresses",          "16-byte, 32 addresses",
      "4-byte, 32 words",               "4-byte, 2 words"};
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* clocks;
  cudaMalloc(&out, sizeof(float) * sms * 32 * kWarps);
  cudaMalloc(&clocks, sizeof(long long) * sms);
  for (int mode = 0; mode < 10; ++mode) {
    for (int rep = 0; rep < 2; ++rep) loads<<<sms, 32 * kWarps>>>(mode, out, clocks);
    long long c = 0;
    if (cudaMemcpy(&c, clocks, sizeof(c), cudaMemcpyDeviceToHost) != cudaSuccess) {
      std::printf("launch failed: %s\n", cudaGetErrorString(cudaGetLastError()));
      return 1;
    }
    std::printf("%-40s %.3f SM clocks a warp load\n", names[mode],
                static_cast<double>(c) / (static_cast<double>(kWarps) * kIters * 8));
  }
  return 0;
}
