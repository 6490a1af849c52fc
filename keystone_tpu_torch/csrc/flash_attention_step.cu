// K3: one online-softmax update of ring attention's carried state.
//
// Replaces keystone_tpu/ops/flash_attention.py::flash_attention_step
// (Pallas kernel _flash_step_kernel), the per-hop kernel of ring
// attention. For q (BH, S_q, D) against one K/V block k, v (BH, S_k, D),
// row-major, f32 or bf16, it reads the carried state m, l (BH, S_q) and
// acc (BH, S_q, D), all f32, and writes the new state to separate
// buffers. The TPU kernel's arithmetic is kept: q, k and v are widened to
// f32 and q is scaled by 1/√D in f32; every product and sum is f32,
// including p·v with p unrounded. Positions are begin-aligned: query row i
// sits at q_offset + i and key j at k_offset + j; key j is valid when
// j < S_k and, when causal, when q_offset + i ≥ k_offset + j. For each
// 64-key tile in order:
//
//   s = valid ? q·k : −1e30;  m_new = max(m, rowmax s);
//   p = valid ? exp(s − m_new) : 0;  alpha = exp(m − m_new);
//   l = l·alpha + Σp;  acc = acc·alpha + p·v;  m = m_new.
//
// Causal tiles wholly past the diagonal are skipped, as num_k_live does on
// the TPU. Skipping is exact: a fully masked tile leaves m, l and acc
// unchanged bit for bit, so a hop with no live key writes its state
// through unchanged.
//
// What bounds it on an H100: a live hop does 4·BH·S_q·S_k·D f32
// operations (half that on the diagonal) against 2·BH·(S_q + S_k)·D input
// bytes in bf16 plus 2·BH·S_q·(D + 2)·4 bytes of state in and out. At the
// ring's hop shape (BH 32, S_q = S_k = 2,048, D 64) that is 3.4e10
// operations, 0.51 ms at the H100 SXM datasheet's 67 TFLOP/s f32 peak on
// CUDA cores, against 59 MB, 18 µs at its 3.35 TB/s: operations bound a
// live hop. A fully masked hop only moves its state: bytes bound it.
//
// Design (simple first version): FMAs on CUDA cores, never TF32, since the
// TPU kernel's contract is f32 arithmetic. One block of 256 threads per
// (b·h, 64-row q tile); it reads the tile's m, l and acc into registers,
// loops over the live 64-key tiles, widening each K/V tile into f32
// shared memory, and writes the new state. Each thread owns a 4 × 4 block
// of the score tile (rows 4·ty.., keys 4·tx..) and the same four rows of
// the accumulator, so the row state lives in registers and a row's max
// and sum are shuffles across the 16 threads that share it. Q and K are
// stored transposed and P transposed, so each step of the two products is
// two 16-byte shared loads for 16 FMAs.
//
// Left for later: tensor cores (split-bf16 or TF32 with a correction term
// to keep f32 accuracy), a cp.async or TMA K/V ring, and skipping the
// launch of a fully masked hop on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per K/V tile
constexpr int kPad = 4;  // keeps rows 16-byte aligned, staggers banks
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool key_valid(int causal, long long qi, int kj,
                                          int s_k, int q_offset,
                                          int k_offset) {
  if (kj >= s_k) return false;
  return !causal || static_cast<long long>(q_offset) + qi >=
                        static_cast<long long>(k_offset) + kj;
}

template <int DMAX>
struct Smem {
  float qt[DMAX][kBQ + kPad];  // scaled Q tile, transposed: qt[c][row]
  float kt[DMAX][kBK + kPad];  // K tile, transposed: kt[c][key]
  float v[kBK][DMAX + kPad];   // V tile: v[key][c]
  float pt[kBK][kBQ + kPad];   // P tile, transposed: pt[key][row]
};

template <int DMAX, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_step(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ m_in,
               const float* __restrict__ l_in,
               const float* __restrict__ acc_in, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ acc_out,
               int s_q, int s_k, int d, int q_tiles, int q_offset,
               int k_offset, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DMAX>& sm = *reinterpret_cast<Smem<DMAX>*>(smem_raw);
  constexpr int kCols = DMAX / 16;  // accumulator columns per thread

  const int bh = blockIdx.x / q_tiles;
  const int q_row0 = (blockIdx.x % q_tiles) * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows 4·ty + i, keys 4·tx + j
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t k_base = static_cast<size_t>(bh) * s_k * d;
  const size_t st_base = static_cast<size_t>(bh) * s_q;

  // column x of this thread's accumulator: 64·(x / 4) + 4·tx + x % 4
  float m_i[4], l_i[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_row0 + 4 * ty + i;
    const bool in = row < s_q;
    m_i[i] = in ? m_in[st_base + row] : kNeg;
    l_i[i] = in ? l_in[st_base + row] : 0.f;
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      const int c = 64 * (x / 4) + 4 * tx + x % 4;
      o[i][x] = (in && c < d)
                    ? acc_in[q_base + static_cast<size_t>(row) * d + c]
                    : 0.f;
    }
  }

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    const int row = q_row0 + r;
    sm.qt[c][r] =
        (row < s_q && c < d)
            ? widen(q[q_base + static_cast<size_t>(row) * d + c]) * scale
            : 0.f;
  }

  const int num_k = (s_k + kBK - 1) / kBK;
  int live = num_k;
  if (causal) {
    // keys up to the tile's last q position: tiles past it are all masked
    const long long span =
        static_cast<long long>(q_offset) + q_row0 + kBQ - k_offset;
    live = span <= 0 ? 0
                     : static_cast<int>(
                           (span + kBK - 1) / kBK < num_k
                               ? (span + kBK - 1) / kBK
                               : num_k);
  }

  for (int kt = 0; kt < live; ++kt) {
    const int key0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DMAX; i += kThreads) {
      const int j = i / DMAX, c = i % DMAX;
      const int kj = key0 + j;
      const bool in = kj < s_k && c < d;
      const size_t off = k_base + static_cast<size_t>(kj) * d + c;
      sm.kt[c][j] = in ? widen(k[off]) : 0.f;
      sm.v[j][c] = in ? widen(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qt[c][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.kt[c][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, row max across the 16 threads of a row, p, row sum
    bool valid[4][4];
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qi = q_row0 + 4 * ty + i;
      mx[i] = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        valid[i][j] =
            key_valid(causal, qi, key0 + 4 * tx + j, s_k, q_offset, k_offset);
        if (!valid[i][j]) s[i][j] = kNeg;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
    float alpha[4], rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off *= 2) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      }
      const float m_new = fmaxf(m_i[i], mx[i]);
      alpha[i] = expf(m_i[i] - m_new);
      m_i[i] = m_new;
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[i][j] ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs[i] += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
      }
      l_i[i] = l_i[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&sm.pt[4 * tx + j][4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    float pv[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < kCols; ++x) pv[i][x] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sm.pt[j][4 * ty]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int h = 0; h < kCols / 4; ++h) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&sm.v[j][64 * h + 4 * tx]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[i][4 * h + e] = fmaf(pr[i], vv[e], pv[i][4 * h + e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < kCols; ++x) o[i][x] = o[i][x] * alpha[i] + pv[i][x];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_row0 + 4 * ty + i;
    if (row >= s_q) continue;
    if (tx == 0) {
      m_out[st_base + row] = m_i[i];
      l_out[st_base + row] = l_i[i];
    }
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      const int c = 64 * (x / 4) + 4 * tx + x % 4;
      if (c < d) acc_out[q_base + static_cast<size_t>(row) * d + c] = o[i][x];
    }
  }
}

template <int DMAX, typename T>
int launch(const void* q, const void* k, const void* v, const void* m_in,
           const void* l_in, const void* acc_in, void* m_out, void* l_out,
           void* acc_out, int bh, int s_q, int s_k, int d, int q_offset,
           int k_offset, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<DMAX>));
  // the shared-memory opt-in is per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(flash_step<DMAX, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int q_tiles = (s_q + kBQ - 1) / kBQ;
  flash_step<DMAX, T>
      <<<static_cast<unsigned>(bh) * q_tiles, kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(m_in),
          static_cast<const float*>(l_in), static_cast<const float*>(acc_in),
          static_cast<float*>(m_out), static_cast<float*>(l_out),
          static_cast<float*>(acc_out), s_q, s_k, d, q_tiles, q_offset,
          k_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* m_in,
             const void* l_in, const void* acc_in, void* m_out, void* l_out,
             void* acc_out, int bh, int s_q, int s_k, int d, int q_offset,
             int k_offset, int causal, float scale, cudaStream_t stream) {
  return d <= 64
             ? launch<64, T>(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                             acc_out, bh, s_q, s_k, d, q_offset, k_offset,
                             causal, scale, stream)
             : launch<128, T>(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                              acc_out, bh, s_q, s_k, d, q_offset, k_offset,
                              causal, scale, stream);
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (q, k, v). The state is float32:
// m_in, l_in, m_out, l_out (BH, S_q); acc_in, acc_out (BH, S_q, D). The
// outputs must not alias the inputs. scale is 1/√D as a float32.
extern "C" int keystone_flash_attention_step(
    const void* q, const void* k, const void* v, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int bh, int s_q, int s_k, int d, int q_offset,
    int k_offset, int causal, float scale, int in_dtype, void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k < 0 || d <= 0 || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    return launch_d<float>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out,
                           bh, s_q, s_k, d, q_offset, k_offset, causal, scale,
                           s);
  }
  if (in_dtype == 1) {
    return launch_d<__nv_bfloat16>(q, k, v, m_in, l_in, acc_in, m_out, l_out,
                                   acc_out, bh, s_q, s_k, d, q_offset,
                                   k_offset, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
