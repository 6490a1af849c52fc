// K3: one online-softmax update of ring attention's carried state.
//
// Replaces keystone_tpu/ops/flash_attention.py::flash_attention_step
// (Pallas kernel _flash_step_kernel), the per-hop kernel of ring
// attention. For q (BH, S_q, D) against one K/V block k, v (BH, S_k, D),
// row-major, f32 or bf16, it reads the carried state m, l (BH, S_q) and
// acc (BH, S_q, D), all f32, and writes the new state to separate
// buffers. The TPU kernel's contract is kept: f32 arithmetic on widened
// inputs, p unrounded. Positions are begin-aligned: query row i sits at
// q_offset + i and key j at k_offset + j; key j is valid when j < S_k and,
// when causal, when q_offset + i ≥ k_offset + j. For each 64-key tile:
//
//   s = valid ? q·k/√D : −1e30;  m_new = max(m, rowmax s);
//   p = valid ? exp(s − m_new) : 0;  alpha = exp(m − m_new);
//   l = l·alpha + Σp;  acc = acc·alpha + p·v;  m = m_new.
//
// Causal tiles wholly past the diagonal are skipped; a fully masked tile
// leaves m, l and acc unchanged bit for bit, so a hop with no live key
// writes its state through unchanged.
//
// What bounds it on an H100: a live hop at the ring's hop shape (BH 32,
// S_q = S_k = 2,048, D 64) does 3.4e10 f32 operations. On CUDA cores (67
// TFLOP/s) that is 0.51 ms, which only tensor cores can beat. With the
// products below, the same hop is 1 bf16 pass for Q·Kᵀ and 3 for P·V,
// 6.9e10 operations: 0.07 ms at 989 TFLOP/s; and 1.3e8 exponentials, about
// 0.035 ms on the special-function units. Its bytes (59 MB) take 18 µs at
// 3.35 TB/s. A fully masked hop only moves its state: bytes bound it.
//
// Design: the bf16 path runs on the Hopper mainloop of attention_sm90.cuh
// (TMA K/V ring, wgmma, a persistent grid, two consumer warpgroups of 64 q
// rows; see there) with the K3 state policy below, which keeps f32
// arithmetic at tensor-core rates:
//   - bf16 q and k are exact, and the product of two bf16 values is exact
//     in f32, so S = Q·Kᵀ on bf16 tensor cores with f32 accumulation is f32
//     arithmetic in another order; s is scaled by 1/√D in f32 after it;
//   - p stays f32 (l sums the f32 p) and splits exactly into three bf16
//     parts, hi = bf16(p), mid = bf16(p − hi), lo = bf16(p − hi − mid)
//     (3 × 8 bits of significand), each bf16 cut (not rounded) from the
//     f32 rest, which is exact and costs no conversion instruction; v is
//     exact in bf16, so P·V is three bf16 passes into one f32
//     accumulator, at D = 64 one of the tile's own, added to the carried
//     acc in f32 (the tensor cores' sum into a large acc loses low bits);
//   - the state is read into the accumulator's registers at the start and
//     written from them at the end, in 16-byte chunks of a row.
// The f32-input path stays on CUDA cores (FMAs, never TF32): 256 threads
// per 64-row tile, each owning a 4 × 4 block of the score tile, with Q, K
// and P transposed in shared memory; the f32 ring checks use it.
//
// Left for later: the overlap of one tile's S with the last tile's P·V,
// which K2 has and K3's registers (three P fragments, two accumulators, S)
// do not allow within the 168 a thread; the three P·V passes, which cost
// three times the products of one; ping-pong scheduling of the two
// consumer warpgroups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_sm90.cuh"

namespace {

constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // keys per K/V tile
constexpr int kPad = 4;  // keeps rows 16-byte aligned, staggers banks
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float widen(float x) { return x; }

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

// K3's policy for the Hopper mainloop: the carried state in and out, s
// scaled in f32 after the exact bf16 product, p split into three bf16
// passes. l is kept as four partial sums per row (one per thread of the
// quad, the carried l in the first) and added at the end.
struct K3State {
  static constexpr int kPasses = 3;
  static constexpr bool kScaleQ = false;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;

  // acc moves as whole 8-column chunks of a row (two 16-byte accesses)
  // where the rows allow (D a multiple of 4), else element by element.
  template <int N>
  __device__ void load(const sm90::Shape& sh, int bh, const int (&row)[2],
                       int t, float (&m)[2], float (&l)[2],
                       float (&o)[N]) const {
    const bool vec = sh.d % 4 == 0 && reinterpret_cast<uintptr_t>(acc_in) % 16 == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < sh.s_q;
      const size_t base = static_cast<size_t>(bh) * sh.s_q + row[r];
      m[r] = in ? m_in[base] : kNeg;
      l[r] = in && t == 0 ? l_in[base] : 0.f;
      const float* src = acc_in + base * sh.d;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const int c0 = 8 * (4 * j + t);
        float2 x[4];
        if (in && vec && c0 + 8 <= sh.d) {
          const float4 a = reinterpret_cast<const float4*>(src + c0)[0];
          const float4 b = reinterpret_cast<const float4*>(src + c0)[1];
          x[0] = make_float2(a.x, a.y);
          x[1] = make_float2(a.z, a.w);
          x[2] = make_float2(b.x, b.y);
          x[3] = make_float2(b.z, b.w);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int c = c0 + 2 * p;
            x[p] = make_float2(in && c < sh.d ? src[c] : 0.f,
                               in && c + 1 < sh.d ? src[c + 1] : 0.f);
          }
        }
        sm90::quad_transpose(x, t);  // chunk → this thread's pairs
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[4 * (4 * j + q) + 2 * r] = x[q].x;
          o[4 * (4 * j + q) + 2 * r + 1] = x[q].y;
        }
      }
    }
  }

  template <int N>
  __device__ void store(const sm90::Shape& sh, int bh, const int (&row)[2],
                        int t, const float (&m)[2], const float (&l)[2],
                        const float (&o)[N]) const {
    const bool vec = sh.d % 4 == 0 && reinterpret_cast<uintptr_t>(acc_out) % 16 == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < sh.s_q;
      const size_t base = static_cast<size_t>(bh) * sh.s_q + row[r];
      if (in && t == 0) {
        m_out[base] = m[r];
        l_out[base] = l[r];
      }
      float* dst = acc_out + base * sh.d;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        float2 x[4];
        sm90::row_chunk(o, r, j, t, 1.f, x);
        const int c0 = 8 * (4 * j + t);
        if (!in) continue;
        if (vec && c0 + 8 <= sh.d) {
          reinterpret_cast<float4*>(dst + c0)[0] = make_float4(x[0].x, x[0].y, x[1].x, x[1].y);
          reinterpret_cast<float4*>(dst + c0)[1] = make_float4(x[2].x, x[2].y, x[3].x, x[3].y);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (c0 + 2 * p < sh.d) dst[c0 + 2 * p] = x[p].x;
            if (c0 + 2 * p + 1 < sh.d) dst[c0 + 2 * p + 1] = x[p].y;
          }
        }
      }
    }
  }
};

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (q, k, v). The state is float32:
// m_in, l_in, m_out, l_out (BH, S_q); acc_in, acc_out (BH, S_q, D). The
// outputs must not alias the inputs. scale is 1/√D as a float32. q, k and v
// have rows of d_in ≥ d elements: bf16 rows must be 16-byte multiples
// (d_in % 8 == 0, the columns past d zero) and the bases 16-byte aligned,
// for TMA; f32 inputs take d_in == d. sched is two int32, zero between
// launches, that the bf16 kernel's persistent blocks take their work from.
extern "C" int keystone_flash_attention_step(
    const void* q, const void* k, const void* v, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int bh, int s_q, int s_k, int d, int d_in, int q_offset,
    int k_offset, int causal, float scale, int in_dtype, void* sched,
    void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k < 0 || d <= 0 || d > 128 || d_in < d ||
      d_in > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && d_in == d) {
    return launch_d<float>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out,
                           bh, s_q, s_k, d, q_offset, k_offset, causal, scale,
                           s);
  }
  if (in_dtype == 1) {
    const sm90::Shape sh{s_q,      s_k,      d,      0,     bh,
                         q_offset, k_offset, causal, scale, 0,
                         static_cast<int*>(sched)};
    const K3State st{static_cast<const float*>(m_in),
                     static_cast<const float*>(l_in),
                     static_cast<const float*>(acc_in),
                     static_cast<float*>(m_out), static_cast<float*>(l_out),
                     static_cast<float*>(acc_out)};
    return d_in <= 64 ? sm90::launch<64>(q, k, v, d_in, sh, st, s)
                      : sm90::launch<128>(q, k, v, d_in, sh, st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of the bf16 kernel takes at row width d_in.
extern "C" int keystone_flash_attention_step_smem_bytes(int d_in) {
  return d_in <= 64 ? sm90::smem_bytes<64, K3State>()
                    : sm90::smem_bytes<128, K3State>();
}

extern "C" const char* keystone_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
