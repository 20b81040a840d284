// Backward of unmasked multi-head self-attention, for Hopper (sm_90a):
// kernel B4 of the port.
//
// Replaces the Pallas TPU kernel parseq_tpu/ops/flash_bwd.py:_bwd_pallas
// (line 64, pallas_call at :86; custom VJP attention_flashbwd), which the
// JAX package runs for encoder self-attention in training. For batch row b
// and head h, with q, k, v, dO of shape (L, dh) and everything in f32:
//   S  = scale * Q K^T          P = softmax(S) (row max, e / sum e)
//   dV = P^T dO                 dP = dO V^T
//   dS = P * (dP - rowsum(dP * P))
//   dQ = scale * dS K           dK = scale * dS^T Q
// Inputs are bf16 or f32 and are widened to f32; P, dP and dS stay f32 and
// every product is an f32 sum of f32 products (as in the TPU kernel, which
// casts its blocks to f32 before the dot_generals); outputs are stored in
// the inputs' type.
//
// What bounds it on this card: it must read q, k, v, dO and write dq, dk,
// dv: 7 * B*L*h*dh * 2 bytes in bf16, 33 MB at PARSeq-S's microbatch
// (B, h, L, dh) = (48, 6, 128, 64), ~9.9 us at 3.35 TB/s. Its
// 10 * L^2 * dh * B*h = 3.0 GFLOP are ~3 us at the bf16 tensor-core peak, so
// the bound is the memory. The plain PyTorch version writes and re-reads the
// (B, h, L, L) f32 scores, probabilities and their gradients (19 MB each at
// that shape) several times.
//
// What the design does about it: the (L, L) tiles never leave the chip.
//   * Pass 1, grid (query tiles of 32, heads, batch): a block stages all of
//     its head's K and V (f32, zero rows past L) and its 32 Q and dO rows in
//     shared memory. Each warp owns 4 query rows; its lanes own key columns
//     j = lane + 32c, so S and dP for those rows live in registers and the
//     softmax max / sum and rowsum(dP * P) are warp shuffles. dS goes to
//     shared memory once, and dQ = scale dS K is written out. The row
//     statistics (max, sum, rowsum(dP * P)) go to a small f32 scratch.
//   * Pass 2, grid (key tiles of 32, heads, batch): a block stages its 32 K
//     and V rows and walks over the query tiles, recomputing S and dP for
//     its keys with the same summation order, P from the stored row max and
//     sum, and accumulating dV and dK for its keys in registers.
//   * Every row in shared memory is padded by 4 floats, so the float4 loads
//     along the head dimension are free of bank conflicts.
// The products run on the f32 cores (67 TFLOP/s peak), not the tensor
// cores: P and dS must not be rounded to bf16. Pass 1 and pass 2 recompute
// S and dP, 14 L^2 dh FLOP per head instead of 10. Not done yet: bf16
// tensor-core products for Q K^T and dO V^T (exact in f32 for bf16 inputs),
// cp.async/TMA staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;               // rows (queries in pass 1, keys in pass 2) per warp
constexpr int kTile = kWarps * kRows;  // 32 rows per block
constexpr int kQT2 = 64;               // query rows per step of pass 2 (2 per lane)
constexpr int kMaxL = 256;
constexpr int kMaxC = kMaxL / 32;      // key columns per lane in pass 1
constexpr int kPad = 4;                // floats of padding per shared row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // (B, H, L, 3): row max, row sum, rowsum(dP * P)
  // (batch, head, row) strides in elements of q, k, v, dout, dq, dk, dv
  long long st[7][3];
  int B, H, L;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [r0, r0 + n) of one head of a (B, H, L, DH) tensor -> f32 shared rows of
// stride DH + kPad; rows at or past L are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs, int r0, int n, int L) {
  for (int e = threadIdx.x; e < n * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[r * (DH + kPad) + d] = (r0 + r < L) ? to_f32(src[(long long)(r0 + r) * rs + d]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const long long* st, int b, int h) {
  return static_cast<const T*>(base) + (long long)b * st[0] + (long long)h * st[1];
}

template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* base, const long long* st, int b, int h) {
  return static_cast<T*>(base) + (long long)b * st[0] + (long long)h * st[1];
}

__host__ __device__ inline int padded_len(int L) { return (L + 31) / 32 * 32; }

template <int DH>
__host__ __device__ inline size_t rows_smem_bytes(int L) {
  const int Lp = padded_len(L);
  return sizeof(float) * (2 * Lp * (DH + kPad) + 2 * kTile * (DH + kPad) + kTile * (Lp + kPad));
}

template <int DH>
__host__ __device__ inline size_t cols_smem_bytes() {
  return sizeof(float) * (2 * kTile * (DH + kPad) + 2 * kQT2 * (DH + kPad) +
                          2 * kTile * (kQT2 + kPad) + 3 * kQT2);
}

// Pass 1: dQ and the row statistics for 32 query rows of one (batch, head).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DH + kPad;
  const int L = p.L, Lp = padded_len(L), C = Lp / 32, SS = Lp + kPad;
  float* sK = smem;
  float* sV = sK + Lp * RS;
  float* sQ = sV + Lp * RS;
  float* sO = sQ + kTile * RS;
  float* sS = sO + kTile * RS;  // dS, (kTile, Lp)

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage<T, DH>(sK, head_ptr<T>(p.k, p.st[1], b, h), p.st[1][2], 0, Lp, L);
  stage<T, DH>(sV, head_ptr<T>(p.v, p.st[2], b, h), p.st[2][2], 0, Lp, L);
  stage<T, DH>(sQ, head_ptr<T>(p.q, p.st[0], b, h), p.st[0][2], q0, kTile, L);
  stage<T, DH>(sO, head_ptr<T>(p.dout, p.st[3], b, h), p.st[3][2], q0, kTile, L);
  __syncthreads();

  // S and dP for this warp's 4 rows x this lane's key columns.
  float s[kRows][kMaxC], dp[kRows][kMaxC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) s[r][c] = dp[r][c] = 0.f;
  const float* qrow = sQ + warp * kRows * RS;
  const float* orow = sO + warp * kRows * RS;
  for (int d = 0; d < DH; d += 4) {
    float4 qv[kRows], ov[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qv[r] = *reinterpret_cast<const float4*>(qrow + r * RS + d);
      ov[r] = *reinterpret_cast<const float4*>(orow + r * RS + d);
    }
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const int j = lane + 32 * c;
        const float4 kv = *reinterpret_cast<const float4*>(sK + j * RS + d);
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * RS + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r][c] = dot4(s[r][c], qv[r], kv);
          dp[r][c] = dot4(dp[r][c], ov[r], vv);
        }
      }
    }
  }

  // Softmax and dS, row by row; rows are whole within the warp.
  float* stats = p.stats + ((long long)b * p.H + h) * L * 3;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r, i = q0 + row;
    float m = -3.402823466e38f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      s[r][c] *= p.scale;
      if (c < C && lane + 32 * c < L) m = fmaxf(m, s[r][c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      s[r][c] = (c < C && lane + 32 * c < L) ? expf(s[r][c] - m) : 0.f;
      sum += s[r][c];
    }
    sum = warp_sum(sum);
    float delta = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      s[r][c] = s[r][c] / sum;  // P
      delta += dp[r][c] * s[r][c];
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) sS[row * SS + lane + 32 * c] = s[r][c] * (dp[r][c] - delta);
    if (lane == 0 && i < L) {
      stats[i * 3 + 0] = m;
      stats[i * 3 + 1] = sum;
      stats[i * 3 + 2] = delta;
    }
  }
  __syncwarp();  // each warp reads back only its own dS rows

  // dQ = scale * dS K: this warp's 4 rows, lanes over the head dimension.
  constexpr int U = DH / 32;
  float acc[kRows][U];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[r][u] = 0.f;
  const float* dsrow = sS + warp * kRows * SS;
  for (int j = 0; j < Lp; j += 4) {
    float4 ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ds[r] = *reinterpret_cast<const float4*>(dsrow + r * SS + j);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      const float k0 = sK[j * RS + d], k1 = sK[(j + 1) * RS + d];
      const float k2 = sK[(j + 2) * RS + d], k3 = sK[(j + 3) * RS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][u] = fmaf(ds[r].x, k0, acc[r][u]);
        acc[r][u] = fmaf(ds[r].y, k1, acc[r][u]);
        acc[r][u] = fmaf(ds[r].z, k2, acc[r][u]);
        acc[r][u] = fmaf(ds[r].w, k3, acc[r][u]);
      }
    }
  }
  T* dq = head_ptr_mut<T>(p.dq, p.st[4], b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i < L)
#pragma unroll
      for (int u = 0; u < U; ++u)
        dq[(long long)i * p.st[4][2] + lane + 32 * u] = from_f32<T>(acc[r][u] * p.scale);
  }
}

// Pass 2: dK and dV for 32 keys of one (batch, head), over all query rows.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) cols_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RS = DH + kPad, PS = kQT2 + kPad, U = DH / 32;
  const int L = p.L;
  float* sK = smem;
  float* sV = sK + kTile * RS;
  float* sQ = sV + kTile * RS;
  float* sO = sQ + kQT2 * RS;
  float* sP = sO + kQT2 * RS;   // (kTile, kQT2): P^T
  float* sD = sP + kTile * PS;  // (kTile, kQT2): dS^T
  float* sSt = sD + kTile * PS; // (kQT2, 3)

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = head_ptr<T>(p.q, p.st[0], b, h);
  const T* oh = head_ptr<T>(p.dout, p.st[3], b, h);
  const float* stats = p.stats + ((long long)b * p.H + h) * L * 3;
  stage<T, DH>(sK, head_ptr<T>(p.k, p.st[1], b, h), p.st[1][2], k0, kTile, L);
  stage<T, DH>(sV, head_ptr<T>(p.v, p.st[2], b, h), p.st[2][2], k0, kTile, L);

  float dk[kRows][U], dv[kRows][U];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u) dk[r][u] = dv[r][u] = 0.f;
  const float* krow = sK + warp * kRows * RS;
  const float* vrow = sV + warp * kRows * RS;

  for (int q0 = 0; q0 < L; q0 += kQT2) {
    __syncthreads();  // the previous step is done with sQ, sO and sSt
    stage<T, DH>(sQ, qh, p.st[0][2], q0, kQT2, L);
    stage<T, DH>(sO, oh, p.st[3][2], q0, kQT2, L);
    for (int e = threadIdx.x; e < 3 * kQT2; e += kThreads)
      sSt[e] = (q0 + e / 3 < L) ? stats[q0 * 3 + e] : 1.f;
    __syncthreads();

    // S and dP for this warp's 4 keys x this lane's 2 queries (same
    // summation order as pass 1, so S is bit-identical).
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      float4 kv[kRows], vv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        kv[r] = *reinterpret_cast<const float4*>(krow + r * RS + d);
        vv[r] = *reinterpret_cast<const float4*>(vrow + r * RS + d);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = lane + 32 * c;
        const float4 qv = *reinterpret_cast<const float4*>(sQ + i * RS + d);
        const float4 ov = *reinterpret_cast<const float4*>(sO + i * RS + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r][c] = dot4(s[r][c], qv, kv[r]);
          dp[r][c] = dot4(dp[r][c], ov, vv[r]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = lane + 32 * c;
      const float m = sSt[i * 3], sum = sSt[i * 3 + 1], delta = sSt[i * 3 + 2];
      const bool live = q0 + i < L;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = live ? expf(s[r][c] * p.scale - m) / sum : 0.f;
        sP[(warp * kRows + r) * PS + i] = pr;
        sD[(warp * kRows + r) * PS + i] = pr * (dp[r][c] - delta);
      }
    }
    __syncwarp();  // each warp reads back only its own key rows of sP / sD

    // dV += P^T dO, dK += dS^T Q for this warp's 4 keys, lanes over dh.
    const float* prow = sP + warp * kRows * PS;
    const float* drow = sD + warp * kRows * PS;
    for (int i = 0; i < kQT2; i += 4) {
      float4 pv[kRows], dv4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(prow + r * PS + i);
        dv4[r] = *reinterpret_cast<const float4*>(drow + r * PS + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = lane + 32 * u;
        const float o0 = sO[i * RS + d], o1 = sO[(i + 1) * RS + d];
        const float o2 = sO[(i + 2) * RS + d], o3 = sO[(i + 3) * RS + d];
        const float x0 = sQ[i * RS + d], x1 = sQ[(i + 1) * RS + d];
        const float x2 = sQ[(i + 2) * RS + d], x3 = sQ[(i + 3) * RS + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dv[r][u] = fmaf(pv[r].x, o0, dv[r][u]);
          dv[r][u] = fmaf(pv[r].y, o1, dv[r][u]);
          dv[r][u] = fmaf(pv[r].z, o2, dv[r][u]);
          dv[r][u] = fmaf(pv[r].w, o3, dv[r][u]);
          dk[r][u] = fmaf(dv4[r].x, x0, dk[r][u]);
          dk[r][u] = fmaf(dv4[r].y, x1, dk[r][u]);
          dk[r][u] = fmaf(dv4[r].z, x2, dk[r][u]);
          dk[r][u] = fmaf(dv4[r].w, x3, dk[r][u]);
        }
      }
    }
  }

  T* dkh = head_ptr_mut<T>(p.dk, p.st[5], b, h);
  T* dvh = head_ptr_mut<T>(p.dv, p.st[6], b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + warp * kRows + r;
    if (j < L)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = lane + 32 * u;
        dkh[(long long)j * p.st[5][2] + d] = from_f32<T>(dk[r][u] * p.scale);
        dvh[(long long)j * p.st[6][2] + d] = from_f32<T>(dv[r][u]);
      }
  }
}

template <typename T, int DH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t rows_bytes = rows_smem_bytes<DH>(p.L), cols_bytes = cols_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(rows_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cols_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cols_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.L + kTile - 1) / kTile, p.H, p.B);
  rows_kernel<T, DH><<<grid, kThreads, rows_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols_kernel<T, DH><<<grid, kThreads, cols_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). q, k, v, dout, dq, dk, dv are
// (B, H, L, DH) tensors of one type (dtype 0: f32, 1: bf16) with unit
// channel stride and the (batch, head, row) strides in `strides` (7 x 3
// elements, in that tensor order). stats: B*H*L*3 f32 scratch. All memory is
// allocated by the caller; the launches are asynchronous on `stream`.
int parseq_flash_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, void* stats, const long long* strides, int B, int H,
                     int L, int DH, int dtype, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.dq = dq; p.dk = dk; p.dv = dv;
  p.stats = static_cast<float*>(stats);
  for (int t = 0; t < 7; ++t)
    for (int e = 0; e < 3; ++e) p.st[t][e] = strides[t * 3 + e];
  p.B = B; p.H = H; p.L = L;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && DH == 32) return launch<float, 32>(p, s);
  if (dtype == 0 && DH == 64) return launch<float, 64>(p, s);
  if (dtype == 1 && DH == 32) return launch<bf16, 32>(p, s);
  if (dtype == 1 && DH == 64) return launch<bf16, 64>(p, s);
  return (int)cudaErrorInvalidValue;
}

int parseq_flash_bwd_max_len() { return kMaxL; }

const char* parseq_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
