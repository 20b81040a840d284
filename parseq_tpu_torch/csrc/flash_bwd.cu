// Backward of unmasked multi-head self-attention, for Hopper (sm_90a):
// kernel B4 of the port.
//
// Replaces the Pallas TPU kernel parseq_tpu/ops/flash_bwd.py:_bwd_pallas
// (line 64, pallas_call at :86; custom VJP attention_flashbwd), which the
// JAX package runs for encoder self-attention in training. For batch row b
// and head h, with q, k, v, dO of shape (L, dh) and every step in f32
// (`_one_head_bwd`, the TPU kernel's rounding points):
//   S  = scale * Q K^T          P = softmax(S) (exact row max, e / sum e)
//   dV = P^T dO                 dP = dO V^T
//   dS = P * (dP - delta)       delta = rowsum(dP * P)
//   dQ = scale * dS K           dK = scale * dS^T Q
// Inputs are bf16 or f32 (all of one type); outputs are stored in it.
//
// What bounds it on this card: it must read q, k, v, dO and write dq, dk,
// dv: 7 * B*L*h*dh * 2 bytes in bf16, 33 MB at PARSeq-S's microbatch
// (B, h, L, dh) = (48, 6, 128, 64), ~9.9 us at 3.35 TB/s. Its five products,
// 10 * L^2 * dh * B*h = 3.0 GFLOP (4.8 with the three split products below
// counted twice), are ~3-5 us at the bf16 tensor-core peak, so the bound is
// the memory.
//
// bf16 design (one kernel, `bwd_kernel`), point by point against the first
// design of this kernel, which it replaces (two passes on the f32 cores):
//   1. One launch, no scratch [pass 1 wrote (B, H, L, 3) f32 row statistics
//      and pass 2 recomputed S and dP from them]: a head's query rows are
//      cut into C = ceil(L / 64) query blocks of 64, one warpgroup each.
//      A warpgroup computes its rows' S and dP against all keys, the exact
//      softmax, delta and dS, and finishes their dQ; it also forms the
//      partial dK and dV of every key over its own 64 queries, and finishes
//      dK and dV of key tile qb (keys 64 qb .. 64 qb + 63, qb its query
//      block) by adding the other warpgroups' partials of those keys, in
//      query-block order, without atomics or device memory. At L <= 128
//      one block holds both warpgroups of a head (the partials go through
//      its shared memory, two named barriers); above, a cluster of C blocks
//      of one warpgroup does (distributed shared memory, cluster barriers).
//      S and dP are computed once, except at L > 128 (C > 2), where the
//      whole score row (128 registers a thread at L = 256) leaves no room
//      for dP's: there dP is formed one 64-key tile at a time, twice (for
//      delta, then for dS), 2 of the 5 products' worth more work at L > 128
//      only, where no model trains.
//   2. Operands once, in bf16 [every block restaged the head's K and V, or
//      Q and dO, widened to f32, one element per thread]: 16-byte cp.async
//      copies stage Q and dO rows and the head's K and V, bf16, zeros past
//      L, in wgmma's core-matrix layout (csrc/hopper.cuh); Q and K first, so
//      S starts while dO and V land. At L <= 128 K and V are staged once per
//      head; in a cluster (L > 128) each block stages them, and the blocks
//      run together, so the second request for a line finds it in L2.
//      Shared memory for dh = 64: 64 KB at L <= 64, 192 KB at L <= 128 (two
//      warpgroups), 160 KB at L <= 192, 208 KB at L <= 256 (a block each).
//   3. S = Q K^T and dP = dO V^T by wgmma m64n64k16 [f32 FFMA], bf16 in,
//      f32 sums, both operands from shared memory. For bf16 inputs each
//      product is exact in f32, so S and dP are the TPU kernel's values up
//      to the order of the sums.
//   4. dV = P^T dO, dQ = dS K and dK = dS^T Q keep P and dS to 16
//      significant bits [f32 FFMA]: each is split into bf16 hi = bf16(x)
//      and lo = bf16(x - hi), and two wgmmas (hi, then lo) go into one f32
//      accumulator; dO, K and Q are exact in bf16. A single bf16 rounding of
//      P and dS would be the library's rounding points, not the TPU
//      kernel's. P^T and dS^T cross the warpgroup's rows, so P and dS go to
//      shared memory as hi and lo tiles (4 x 64 x 64 bf16 = 32 KB a key
//      tile and warpgroup), which wgmma reads K-major for dQ and, with its
//      transpose bit, MN-major for dV and dK.
//   5. The softmax stays in registers [dS went through shared memory and
//      dQ was a scalar loop over it]: a warp holds its 16 query rows' whole
//      S and dP rows in the wgmma accumulators; exact max and sum by quad
//      shuffles, exp as one FFMA and ex2, P normalised in f32, delta from
//      the f32 P and dP, dS formed in place and split (two packed converts
//      a pair) on its way to shared memory.
//   6. Filling the card: at L <= 128 a block (8 warps, 192 KB, one a SM)
//      is persistent: the grid is as many blocks as the card holds at once
//      (132), each walks the heads blockIdx.x, + 132, ..., and stages the
//      next head's K and V as soon as its dQ is done with them and its Q
//      and dO rows once its key tiles are, so only a block's first head
//      waits for its operands. (48, 6, 128, 64) is 288 heads: 2.2 heads a
//      block, so the last round is one fifth full (the tail stays);
//      (384, 6, 128, 64) is 2,304 heads, 17.5 a block. Above L = 128 a
//      cluster per head, as many as the card holds, in waves. dQ, dK and dV
//      leave through shared memory as whole 16-byte row pieces; the partial
//      tiles a warpgroup hands on go where its P and dS tiles of the same
//      keys were, and it computes its own key tile last, so the exchange
//      needs no more shared memory.
// f32 operands keep the first design's two passes on the f32 cores
// (namespace fp32 below; TF32 tensor cores would not hold the f32 limits):
// checked on the card, not timed; no model path trains in f32 on the card.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace fp32 {

// The first design's two-pass kernels, instantiated for f32 operands only.

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
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

}  // namespace fp32

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWgThreads = 128;  // threads of a warpgroup
constexpr int kTile = 64;      // query rows of a block; keys of a key tile
constexpr int kTileElems = kTile * kTile;
constexpr int kMaxL = 256;
constexpr float kNegMax = -3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // (batch, head, row) strides in elements of q, k, v, dout, dq, dk, dv
  long long st[7][3];
  long long BH;  // heads: batch rows x heads
  int H, L;
  float scale, scale_log2;  // scale, scale * log2 e
};

// Warpgroups of a block: at 64 < L <= 128 one block holds both query
// blocks of a head; otherwise one, and a cluster of C blocks owns a head.
template <int C>
__host__ __device__ constexpr int warpgroups() { return C == 2 ? 2 : 1; }

// Shared memory: K and V (64 C rows each) and, per warpgroup, its Q and dO
// rows and per key tile the P hi, P lo, dS hi and dS lo tiles (64 x 64 each).
template <int DH, int C>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (2 * (size_t)kTile * C * DH +
                         warpgroups<C>() * (2 * (size_t)kTile * DH + (size_t)C * 4 * kTileElems));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi), 16 significant
// bits of each x between them, at dst and dst + lo_off.
__device__ __forceinline__ void put_split(bf16* dst, int lo_off, float x0, float x1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  *reinterpret_cast<__nv_bfloat162*>(dst) = hi;
  *reinterpret_cast<__nv_bfloat162*>(dst + lo_off) =
      __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
}

template <int DH, int C>
__global__ void __launch_bounds__(kWgThreads * warpgroups<C>(), C == 1 ? 2 : 1)
    bwd_kernel(const Params p) {
  constexpr int WG = warpgroups<C>();
  constexpr int CL = C / WG;     // blocks of a cluster
  constexpr int kThreads = kWgThreads * WG;
  constexpr int NC = DH / 8;     // 16-byte chunks of a staged row
  constexpr int KS = DH / 16;    // k-steps of Q K^T and dO V^T
  constexpr int NA = DH / 2;     // accumulators a thread holds of a (64, DH) product
  constexpr int Lk = kTile * C;  // keys staged (zeros past L)
  constexpr bool kDpResident = C <= 2;
  constexpr uint32_t kRowLbo = NC * 128;  // bytes between 8-row groups of a staged operand
  constexpr int kOutRow = DH + 8;  // elements of an output row in shared memory (no bank conflicts)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + Lk * DH;
  bf16* sQs = sV + Lk * DH;            // the block's Q rows, warpgroup w's from row 64 w
  bf16* sOs = sQs + WG * kTile * DH;   // its dO rows, likewise
  bf16* sPSs = sOs + WG * kTile * DH;  // warpgroup w, key tile t, operand o (P hi, P lo,
                                       // dS hi, dS lo) at ((w C + t) 4 + o) tiles

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int L = p.L, qb = rank * WG + wg, q0 = qb * kTile;  // this warpgroup's query block
  bf16* sQ = sQs + wg * kTile * DH;
  bf16* sO = sOs + wg * kTile * DH;
  bf16* sPS = sPSs + wg * C * 4 * kTileElems;
  // Element offset of head bh in tensor t.
  auto at = [&](long long bh, int t) {
    const long long b = bh / p.H;
    return b * p.st[t][0] + (bh - b * p.H) * p.st[t][1];
  };
  // Barrier of this warpgroup's threads.
  auto wg_sync = [&]() {
    if constexpr (WG == 1) {
      __syncthreads();
    } else {
      bar_sync(1 + wg, kWgThreads);
    }
  };

  // Rows r0 .. r0 + rows - 1 of one head into core matrices, zeros past L.
  auto stage = [&](bf16* dst, const bf16* src, long long rs, int r0, int rows) {
    for (int idx = tid; idx < rows * NC; idx += kThreads) {
      const int r = idx / NC, c = idx - r * NC, row = r0 + r;
      cp_async16(dst + core_at(r, 8 * c, NC), src + (row < L ? row : 0) * rs + 8 * c, row < L);
    }
  };
  // This warpgroup's 64 rows of one head, likewise.
  auto stage_wg = [&](bf16* dst, const bf16* src, long long rs) {
    for (int idx = wtid; idx < kTile * NC; idx += kWgThreads) {
      const int r = idx / NC, c = idx - r * NC, row = q0 + r;
      cp_async16(dst + core_at(r, 8 * c, NC), src + (row < L ? row : 0) * rs + 8 * c, row < L);
    }
  };
  // Without a cluster a block is persistent: it walks the heads bh =
  // blockIdx.x, + gridDim.x, ..., and stages the next head's K and V once
  // its dQ is done with them, and its Q and dO rows once its key tiles are.
  const long long stride = gridDim.x / CL;
  for (long long bh = blockIdx.x / CL; bh < p.BH; bh += stride) {
    const bool first = bh == blockIdx.x / CL, more = CL == 1 && bh + stride < p.BH;
    if (first) {
      // Group 0: the block's Q rows and K; group 1: its dO rows and V, which
      // land while S is computed.
      const int row0 = rank * WG * kTile;
      stage(sQs, p.q + at(bh, 0), p.st[0][2], row0, WG * kTile);
      stage(sK, p.k + at(bh, 1), p.st[1][2], 0, Lk);
      cp_async_commit();
      stage(sOs, p.dout + at(bh, 3), p.st[3][2], row0, WG * kTile);
      stage(sV, p.v + at(bh, 2), p.st[2][2], 0, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // K-major operands of S and dP: this block's Q or dO rows (A) and the
    // 64 keys of tile t (B), channels 16 ks .. 16 ks + 15.
    auto rows_desc = [&](const bf16* x, int ks) {
      return wgmma_desc(x + core_at(0, 16 * ks, NC), 128, kRowLbo);
    };
    auto keys_desc = [&](const bf16* x, int t, int ks) {
      return wgmma_desc(x + core_at(kTile * t, 16 * ks, NC), 128, kRowLbo);
    };
    // dP for key tile t (accumulator layout; zeros in d on entry).
    auto dp_tile = [&](float* d, int t) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_ss64<0, 0>(d, rows_desc(sO, ks), keys_desc(sV, t, ks));
    };

    // S (and dP) of the block's 64 query rows against every key: a warp holds
    // rows 16 warp + g and + 8, keys 64 t + 8 nt + 2 tg + {0, 1} at
    // s[t][4 nt + {0, 1}] and s[t][4 nt + {2, 3}].
    float s[C][32];
    float dp[kDpResident ? C : 1][32];
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[t][i] = 0.f;
#pragma unroll
    for (int t = 0; t < (kDpResident ? C : 1); ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[t][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_ss64<0, 0>(s[t], rows_desc(sQ, ks), keys_desc(sK, t, ks));
    wgmma_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if constexpr (kDpResident) {
#pragma unroll
      for (int t = 0; t < C; ++t) dp_tile(dp[t], t);
    }
    wgmma_commit_and_wait();

    // Exact softmax of the scaled scores: keys past L masked, the whole
    // row's max, exp(scale (s - m)) as ex2(s c - m c), its sum, P = e / sum.
    float ma = kNegMax, mb = kNegMax;
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = kTile * t + 8 * nt + 2 * tg;
        if (kTile * t + 8 * nt + 8 > L) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key + e >= L) s[t][4 * nt + e] = s[t][4 * nt + 2 + e] = kNegMax;
        }
        ma = fmaxf(ma, fmaxf(s[t][4 * nt], s[t][4 * nt + 1]));
        mb = fmaxf(mb, fmaxf(s[t][4 * nt + 2], s[t][4 * nt + 3]));
      }
    ma = quad_max(ma);
    mb = quad_max(mb);
    const float c = p.scale_log2, mca = -ma * c, mcb = -mb * c;
    float pa[4] = {0.f, 0.f, 0.f, 0.f}, pb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[t][4 * nt + e] = exp2f(fmaf(s[t][4 * nt + e], c, mca));
          s[t][4 * nt + 2 + e] = exp2f(fmaf(s[t][4 * nt + 2 + e], c, mcb));
          pa[nt & 3] += s[t][4 * nt + e];
          pb[nt & 3] += s[t][4 * nt + 2 + e];
        }
    const float ia = 1.f / quad_sum((pa[0] + pa[1]) + (pa[2] + pa[3]));
    const float ib = 1.f / quad_sum((pb[0] + pb[1]) + (pb[2] + pb[3]));
#pragma unroll
    for (int t = 0; t < C; ++t)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[t][4 * nt] *= ia;
        s[t][4 * nt + 1] *= ia;
        s[t][4 * nt + 2] *= ib;
        s[t][4 * nt + 3] *= ib;
      }

    // delta = rowsum(dP * P), from the f32 P and dP.
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float d1[kDpResident ? 1 : 32];
      float* d = d1;
      if constexpr (kDpResident) {
        d = dp[t];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) d1[i] = 0.f;
        wgmma_fence();
        dp_tile(d1, t);
        wgmma_commit_and_wait();
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        da = fmaf(s[t][4 * nt], d[4 * nt], da);
        da = fmaf(s[t][4 * nt + 1], d[4 * nt + 1], da);
        db = fmaf(s[t][4 * nt + 2], d[4 * nt + 2], db);
        db = fmaf(s[t][4 * nt + 3], d[4 * nt + 3], db);
      }
    }
    da = quad_sum(da);
    db = quad_sum(db);

    // dS = P (dP - delta); P and dS split into bf16 hi + lo tiles in shared
    // memory, rows as queries and 16-byte chunks as 8 keys.
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float d1[kDpResident ? 1 : 32];
      float* d = d1;
      if constexpr (kDpResident) {
        d = dp[t];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) d1[i] = 0.f;
        wgmma_fence();
        dp_tile(d1, t);
        wgmma_commit_and_wait();
      }
      bf16* tile = sPS + 4 * t * kTileElems;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int off = core_at(16 * warp + g, 8 * nt + 2 * tg, 8);
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows g, g + 8
          const float delta = half ? db : da;
          const int i0 = 4 * nt + 2 * half, o = off + half * 512;
          const float p0 = s[t][i0], p1 = s[t][i0 + 1];
          put_split(tile + o, kTileElems, p0, p1);
          put_split(tile + 2 * kTileElems + o, kTileElems, p0 * (d[i0] - delta),
                    p1 * (d[i0 + 1] - delta));
        }
      }
    }
    fence_proxy_async();
    wg_sync();

    // dQ = scale * dS K: A = dS hi / lo (K-major: queries x keys), B = K
    // (MN-major: keys x channels), 16 keys a step.
    // A (64, DH) accumulator times `scale` to bf16 rows of kOutRow elements in
    // shared memory (rows 16 warp + g and + 8, channels 8 nt + 2 tg + {0, 1}),
    // and those rows to the tensor: rows r0 .. r0 + 63 below L, 16 bytes a copy.
    auto put_rows = [&](bf16* dst, const float* a, float scale) {
#pragma unroll
      for (int nt = 0; nt < NA / 4; ++nt) {
        bf16* row = dst + (16 * warp + g) * kOutRow + 8 * nt + 2 * tg;
        *reinterpret_cast<__nv_bfloat162*>(row) =
            __floats2bfloat162_rn(a[4 * nt] * scale, a[4 * nt + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * kOutRow) =
            __floats2bfloat162_rn(a[4 * nt + 2] * scale, a[4 * nt + 3] * scale);
      }
    };
    auto store_rows = [&](bf16* dst, long long rs, const bf16* src, int r0) {
#pragma unroll
      for (int idx = wtid; idx < kTile * NC; idx += kWgThreads) {
        const int r = idx / NC, c = idx - r * NC;
        if (r0 + r < L)
          *reinterpret_cast<uint4*>(dst + (r0 + r) * rs + 8 * c) =
              *reinterpret_cast<const uint4*>(src + r * kOutRow + 8 * c);
      }
    };
    {
      float acc[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < C; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint64_t kd = wgmma_desc(sK + core_at(kTile * t + 16 * u, 0, NC), kRowLbo, 128);
#pragma unroll
          for (int w = 2; w < 4; ++w)
            wgmma_ss<DH, 0, 1>(
                acc, wgmma_desc(sPS + (4 * t + w) * kTileElems + core_at(0, 16 * u, 8), 128, 1024),
                kd);
        }
      wgmma_commit_and_wait();
      // K and V are no longer read (by either warpgroup): dQ goes through
      // them to whole-row stores.
      __syncthreads();
      put_rows(sK + wg * kTile * kOutRow, acc, p.scale);
      wg_sync();
      store_rows(p.dq + at(bh, 4), p.st[4][2], sK + wg * kTile * kOutRow, q0);
    }
    if (more) {  // the next head's K and V, once both warpgroups' dQ rows have left
      __syncthreads();
      stage(sK, p.k + at(bh + stride, 1), p.st[1][2], 0, Lk);
      stage(sV, p.v + at(bh + stride, 2), p.st[2][2], 0, Lk);
      cp_async_commit();
    }

    // Partial dV = P^T dO and dK = dS^T Q of key tile t over this block's
    // queries: A = P or dS hi / lo read MN-major (keys x queries), B = dO or
    // Q (MN-major: queries x channels), 16 queries a step.
    float dv[NA], dk[NA];
    auto key_tile = [&](int t) {
#pragma unroll
      for (int i = 0; i < NA; ++i) dv[i] = dk[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t od = wgmma_desc(sO + core_at(16 * u, 0, NC), kRowLbo, 128);
        const uint64_t qd = wgmma_desc(sQ + core_at(16 * u, 0, NC), kRowLbo, 128);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          wgmma_ss<DH, 1, 1>(
              w < 2 ? dv : dk,
              wgmma_desc(sPS + (4 * t + w) * kTileElems + core_at(16 * u, 0, 8), 1024, 128),
              w < 2 ? od : qd);
      }
      wgmma_commit_and_wait();
    };
    // The other query blocks' key tiles first, each partial left in the
    // shared memory of that tile's P and dS (no longer read); the own last.
    // The owner of key tile t (warpgroup t of the head) adds the partials in
    // the order of the query blocks: from the other warpgroup of the block
    // (L <= 128, named barriers 3 and 4: "warpgroup w's partials are in
    // place") or from the other blocks of the cluster (distributed shared
    // memory, cluster barriers).
    for (int i = 1; i < C; ++i) {
      const int t = (qb + i) % C;
      key_tile(t);
      wg_sync();  // the products of tile t are done with its P and dS
      float4* slot = reinterpret_cast<float4*>(sPS + 4 * t * kTileElems);
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        slot[j * kWgThreads + wtid] =
            make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]);
        slot[(NA / 4 + j) * kWgThreads + wtid] =
            make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2], dk[4 * j + 3]);
      }
    }
    if constexpr (CL > 1) {
      cluster_arrive();
    } else if constexpr (WG > 1) {
      __threadfence_block();
      bar_arrive(3 + wg, 2 * kWgThreads);
    }
    key_tile(qb);
    if (more) {  // the next head's Q and dO rows of this warpgroup
      stage_wg(sQ, p.q + at(bh + stride, 0), p.st[0][2]);
      stage_wg(sO, p.dout + at(bh + stride, 3), p.st[3][2]);
      cp_async_commit();
    }
    if constexpr (C > 1) {
      if constexpr (CL > 1) {
        cluster_wait();
      } else {
        bar_sync(3 + (1 - wg), 2 * kWgThreads);
      }
      for (int r = 0; r < C; ++r) {
        if (r == qb) continue;
        const float4* src =
            reinterpret_cast<const float4*>(sPSs + ((r % WG) * C + qb) * 4 * kTileElems);
        if constexpr (CL > 1) src = cluster.map_shared_rank(src, r / WG);
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          const float4 x = src[j * kWgThreads + wtid], y = src[(NA / 4 + j) * kWgThreads + wtid];
          dv[4 * j] += x.x; dv[4 * j + 1] += x.y; dv[4 * j + 2] += x.z; dv[4 * j + 3] += x.w;
          dk[4 * j] += y.x; dk[4 * j + 1] += y.y; dk[4 * j + 2] += y.z; dk[4 * j + 3] += y.w;
        }
      }
      if constexpr (CL > 1) cluster_arrive();  // done reading the other blocks' shared memory
    }
    // The own key tile's P and dS are no longer read (and nobody else reads
    // them): dK and dV go through them to whole-row stores.
    bf16* out = sPS + 4 * qb * kTileElems;
    wg_sync();
    put_rows(out, dk, p.scale);
    put_rows(out + kTile * kOutRow, dv, 1.f);
    wg_sync();
    store_rows(p.dk + at(bh, 5), p.st[5][2], out, q0);
    store_rows(p.dv + at(bh, 6), p.st[6][2], out + kTile * kOutRow, q0);
    if constexpr (CL > 1) cluster_wait();  // no block leaves while another reads its shared memory
  }
}

template <int DH, int C>
int launch_bf16(const Params& p, long long BH, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH, C>();
  constexpr int CL = C / warpgroups<C>();
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  long long blocks = BH * CL;
  if constexpr (CL == 1) {  // persistent: as many blocks as fit on the card at once
    static int resident = 0;  // blocks of this instantiation the card holds at once
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) == cudaSuccess &&
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<DH, C>,
                                                        kWgThreads * warpgroups<C>(),
                                                        bytes) == cudaSuccess)
        resident = sms * per_sm;
    }
    if (resident > 0 && resident < blocks) blocks = resident;
  }
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kWgThreads * warpgroups<C>());
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_kernel<DH, C>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const Params& p, long long BH, cudaStream_t stream) {
  switch ((p.L + kTile - 1) / kTile) {
    case 1: return launch_bf16<DH, 1>(p, BH, stream);
    case 2: return launch_bf16<DH, 2>(p, BH, stream);
    case 3: return launch_bf16<DH, 3>(p, BH, stream);
    default: return launch_bf16<DH, 4>(p, BH, stream);
  }
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). q, k, v, dout, dq, dk, dv are
// (B, H, L, DH) tensors of one type (dtype 0: f32, 1: bf16) with unit
// channel stride and the (batch, head, row) strides in `strides` (7 x 3
// elements, in that tensor order); bf16 needs strides that are multiples
// of 8 and 16-byte aligned pointers. stats: B*H*L*3 f32 scratch for f32
// operands (the two f32 passes), unused (may be null) for bf16. All memory
// is allocated by the caller; the launches are asynchronous on `stream`.
int parseq_flash_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, void* stats, const long long* strides, int B, int H,
                     int L, int DH, int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || (DH != 32 && DH != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    long long any = 0;
    for (int i = 0; i < 21; ++i) any |= strides[i];
    if (any & 7) return (int)cudaErrorInvalidValue;
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    for (const void* ptr : ptrs)
      if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
    if ((long long)B * H * ((L + kTile - 1) / kTile) > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    Params p;
    p.q = static_cast<const bf16*>(q); p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v); p.dout = static_cast<const bf16*>(dout);
    p.dq = static_cast<bf16*>(dq); p.dk = static_cast<bf16*>(dk); p.dv = static_cast<bf16*>(dv);
    for (int t = 0; t < 7; ++t)
      for (int e = 0; e < 3; ++e) p.st[t][e] = strides[t * 3 + e];
    p.BH = (long long)B * H;
    p.H = H;
    p.L = L;
    p.scale = scale;
    p.scale_log2 = scale * kLog2e;
    return DH == 32 ? launch_bf16<32>(p, p.BH, s) : launch_bf16<64>(p, p.BH, s);
  }
  if (dtype != 0 || B > 65535 || H > 65535 || stats == nullptr) return (int)cudaErrorInvalidValue;
  fp32::Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.dq = dq; p.dk = dk; p.dv = dv;
  p.stats = static_cast<float*>(stats);
  for (int t = 0; t < 7; ++t)
    for (int e = 0; e < 3; ++e) p.st[t][e] = strides[t * 3 + e];
  p.B = B; p.H = H; p.L = L;
  p.scale = scale;
  return DH == 32 ? fp32::launch<float, 32>(p, s) : fp32::launch<float, 64>(p, s);
}

int parseq_flash_bwd_max_len() { return kMaxL; }

const char* parseq_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

