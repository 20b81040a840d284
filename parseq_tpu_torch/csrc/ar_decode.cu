// Fused greedy AR decode of PARSeq (dec_depth == 1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel parseq_tpu/ops/ar_kernel.py:_kernel
// (wrapper ar_decode_fused). One launch runs all num_steps greedy steps:
// embed the previous token, norm_c LN, project its K/V into a cache,
// single-query causal self-attention over the cache, cross-attention to the
// pre-projected memory K/V, pre-LN MLP with exact-erf GELU, final LN, head,
// argmax. Numerics follow the TPU kernel: matmul inputs bf16 with f32
// accumulation and f32 bias; residual stream, scores, softmax and the
// q/cross-q projections f32; K/V cache bf16.
//
// What bounds it on this card: every step is a chain of matrix-vector
// products over all decoder weights (~3.9 MB in bf16: K|V, out, cross q,
// cross out, MLP 384x1536 twice, head; L2-resident after the first step),
// plus a read of the row's memory K/V (2 x M x D bf16 = 196 KB at M=128,
// D=384) -- far below the tensor-core ridge. Measured on an H100 SXM
// (700 W), one block's 26 steps take 3.3 / 4.5 / 6.9 / 13.1 ms at R = 1 / 2
// / 4 / 8 rows: per-row work inside the block (latency-bound L2 loads of the
// matvecs, the loops over memory keys, the shuffle reductions) bounds it
// more than the weight stream the rows share.
//
// What the design does about it:
//   * R batch rows per block (template: 1, 2, 4, 8) share each weight read;
//     the wrapper picks the smallest R that keeps the grid within one wave
//     of SMs, since a block's latency grows with R. Ragged last block:
//     rows past B are computed on a clamped memory row and never stored.
//   * Weights stay in torch (out, in) layout: one warp per output row reads
//     contiguous 16-byte chunks along the input dimension and reduces with
//     shuffles; 4 output rows per warp iteration keep 4 loads in flight.
//   * Activations (residual stream, matvec inputs/outputs, probabilities)
//     live in shared memory; the K/V cache is global scratch owned by the
//     block (L2-resident), written and read back after __syncthreads.
//   * Attention: one warp per (row, head); dh == 32 is one lane per channel.
//     Scores: one lane per key, 16-byte loads of the key's 32 channels.
//     Keys 0..i are looped directly (no -1e9 mask); the embedding row is
//     indexed (no one-hot matmul); C = 95 classes are handled directly
//     (no 128-lane padding). Argmax takes the lowest index on ties.
// Not done yet: tensor cores (mma/wgmma) for larger R, TMA weight streaming.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 32;   // head width handled by one warp
constexpr int kNJ = 4;    // matvec output rows per warp iteration

struct Params {
  const bf16* mem_k;    // (B, M, D) cross-attention keys of memory
  const bf16* mem_v;    // (B, M, D)
  const bf16* emb;      // (num_tokens, D) bf16(sqrt(D) * embedding)
  const float* pos_add; // (n, D) content positional rows, row 0 = 0
  const float* pos_q;   // (n, D) pos_queries (query stream input)
  const float* q_proj;  // (n, D) self-attn q of norm_q(pos_queries), f32
  const bf16* w_kv;  const float* b_kv;   // (2D, D), (2D) self-attn k|v
  const bf16* w_o;   const float* b_o;    // (D, D) self-attn out
  const bf16* w_cq;  const float* b_cq;   // (D, D) cross-attn q
  const bf16* w_co;  const float* b_co;   // (D, D) cross-attn out
  const bf16* w_1;   const float* b_1;    // (F, D) linear1
  const bf16* w_2;   const float* b_2;    // (D, F) linear2
  const bf16* w_h;   const float* b_h;    // (C, D) head
  const float* ln;   // (8, D): norm_c w/b, norm1 w/b, norm2 w/b, decoder.norm w/b
  float* logits;     // (B, n, C)
  bf16* k_cache;     // (gridDim.x * R, n, D) scratch
  bf16* v_cache;
  int B, M, D, H, n, C, F, bos_id;
};

struct Layout {
  int BW, XS, SCW;                         // row strides: matvec out, matvec in, probs
  size_t tgt, buf, cq, q, sc, xb, tok, bytes;  // byte offsets
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout make_layout(const Params& p, int R) {
  Layout L;
  L.BW = imax(imax(2 * p.D, p.F), p.C);
  L.XS = imax(p.D, p.F);
  L.SCW = imax(p.M, p.n);
  size_t off = 0;
  L.tgt = off; off += sizeof(float) * R * p.D;
  L.buf = off; off += sizeof(float) * R * L.BW;
  L.cq = off;  off += sizeof(float) * R * p.D;
  L.q = off;   off += sizeof(float) * p.D;
  L.sc = off;  off += sizeof(float) * kWarps * L.SCW;
  off = (off + 15) & ~size_t(15);
  L.xb = off;  off += sizeof(bf16) * R * L.XS;
  L.tok = off; off += sizeof(int) * R;
  L.bytes = off;
  return L;
}

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

// 8 packed bf16 -> 8 floats (exact).
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// out[r, j] = sum_k x[r, k] * W[j, k] + bias[j] for r < R, j < N.
// W: (N, K) bf16 row-major in global memory, K % 8 == 0.
// x: bf16 in shared memory, row stride xs. out: f32 shared, row stride os.
template <int R>
__device__ void matvec(const bf16* __restrict__ W, const float* __restrict__ bias,
                       int N, int K, const bf16* x, int xs, float* out, int os) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K8 = K >> 3;
  for (int j0 = warp * kNJ; j0 < N; j0 += kWarps * kNJ) {
    float acc[kNJ][R];
#pragma unroll
    for (int u = 0; u < kNJ; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[u][r] = 0.f;
    for (int c = lane; c < K8; c += 32) {
      float wf[kNJ][8];
#pragma unroll
      for (int u = 0; u < kNJ; ++u) {
        const int j = j0 + u;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (j < N) w = __ldg(reinterpret_cast<const uint4*>(W + (size_t)j * K) + c);
        unpack8(w, wf[u]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float xf[8];
        unpack8(*reinterpret_cast<const uint4*>(x + r * xs + c * 8), xf);
#pragma unroll
        for (int u = 0; u < kNJ; ++u)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[u][r] = fmaf(xf[e], wf[u][e], acc[u][r]);
      }
    }
#pragma unroll
    for (int u = 0; u < kNJ; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[u][r] = warp_sum(acc[u][r]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kNJ; ++u) {
        const int j = j0 + u;
        if (j < N) {
#pragma unroll
          for (int r = 0; r < R; ++r) out[r * os + j] = acc[u][r] + bias[j];
        }
      }
    }
  }
}

// LayerNorm of R f32 rows (stride xs) -> bf16 rows (stride ys); one warp per row.
template <int R>
__device__ void layer_norm_rows(const float* x, int xs, const float* __restrict__ g,
                                const float* __restrict__ b, int D, bf16* y, int ys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x + r * xs;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = xr[d] - mean;
      v += t * t;
    }
    const float inv = rsqrtf(warp_sum(v) / D + 1e-5f);
    for (int d = lane; d < D; d += 32)
      y[r * ys + d] = __float2bfloat16((xr[d] - mean) * inv * g[d] + b[d]);
  }
}

// One warp per (row, head): softmax(q . k_j / sqrt(dh)) over keys j < nkeys,
// then sum_j p_j v_j, written as bf16 into out (row stride os).
// q: f32 shared, row stride qs (qs == 0: one query for all rows).
// keys/vals of row r start at kbase[r] / vbase[r] with key stride D.
template <int R>
__device__ void attend(const float* q, int qs, const bf16* const* kbase,
                       const bf16* const* vbase, int nkeys, int D, int H,
                       float* sc_all, int scw, bf16* out, int os) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_sqrt_dh = 1.0f / sqrtf((float)kDh);  // both correctly rounded
  float* sc = sc_all + warp * scw;
  for (int pair = warp; pair < R * H; pair += kWarps) {
    const int r = pair / H, h = pair % H;
    const float* qh = q + r * qs + h * kDh;
    const bf16* kb = kbase[r] + h * kDh;
    const bf16* vb = vbase[r] + h * kDh;
    float m = -3.402823466e38f;
    for (int j = lane; j < nkeys; j += 32) {
      const uint4* kp = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kDh / 8; ++c) {
        float kf[8];
        unpack8(kp[c], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(kf[e], qh[c * 8 + e], s);
      }
      s *= inv_sqrt_dh;
      sc[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nkeys; j += 32) {
      const float e = expf(sc[j] - m);
      sc[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < nkeys; ++j)
      o = fmaf(sc[j] / sum, __bfloat162float(vb[(size_t)j * D + lane]), o);
    out[r * os + h * kDh + lane] = __float2bfloat16(o);
    __syncwarp();
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) ar_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(p, R);
  float* s_tgt = reinterpret_cast<float*>(smem + L.tgt);
  float* s_buf = reinterpret_cast<float*>(smem + L.buf);
  float* s_cq = reinterpret_cast<float*>(smem + L.cq);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_sc = reinterpret_cast<float*>(smem + L.sc);
  bf16* s_xb = reinterpret_cast<bf16*>(smem + L.xb);
  int* s_tok = reinterpret_cast<int*>(smem + L.tok);

  const int tid = threadIdx.x;
  const int D = p.D, n = p.n, C = p.C, F = p.F, M = p.M;
  const int row0 = blockIdx.x * R;
  const float* ln = p.ln;

  const bf16* kc[R];
  const bf16* vc[R];
  const bf16* mk[R];
  const bf16* mv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kc[r] = p.k_cache + (size_t)(row0 + r) * n * D;
    vc[r] = p.v_cache + (size_t)(row0 + r) * n * D;
    const int bm = min(row0 + r, p.B - 1);  // ragged edge: valid data, never stored
    mk[r] = p.mem_k + (size_t)bm * M * D;
    mv[r] = p.mem_v + (size_t)bm * M * D;
  }
  if (tid < R) s_tok[tid] = p.bos_id;
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // ---- content row: embed the entering token, add position, norm_c
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_buf[r * L.BW + d] = __bfloat162float(p.emb[(size_t)s_tok[r] * D + d]) + p.pos_add[i * D + d];
    }
    for (int d = tid; d < D; d += kThreads) s_q[d] = p.q_proj[i * D + d];
    __syncthreads();
    layer_norm_rows<R>(s_buf, L.BW, ln, ln + D, D, s_xb, L.XS);
    __syncthreads();
    // ---- K/V of the new content row -> cache (bf16)
    matvec<R>(p.w_kv, p.b_kv, 2 * D, D, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * 2 * D; idx += kThreads) {
      const int r = idx / (2 * D), j = idx - r * 2 * D;
      bf16* dst = j < D ? p.k_cache : p.v_cache;
      dst[((size_t)(row0 + r) * n + i) * D + (j < D ? j : j - D)] = __float2bfloat16(s_buf[r * L.BW + j]);
    }
    __syncthreads();
    // ---- self-attention over keys 0..i with the precomputed f32 query
    attend<R>(s_q, 0, kc, vc, i + 1, D, p.H, s_sc, L.SCW, s_xb, L.XS);
    __syncthreads();
    matvec<R>(p.w_o, p.b_o, D, D, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] = p.pos_q[i * D + d] + s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- cross-attention to memory
    layer_norm_rows<R>(s_tgt, D, ln + 2 * D, ln + 3 * D, D, s_xb, L.XS);
    __syncthreads();
    matvec<R>(p.w_cq, p.b_cq, D, D, s_xb, L.XS, s_cq, D);
    __syncthreads();
    attend<R>(s_cq, D, mk, mv, M, D, p.H, s_sc, L.SCW, s_xb, L.XS);
    __syncthreads();
    matvec<R>(p.w_co, p.b_co, D, D, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] += s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- MLP with exact-erf GELU
    layer_norm_rows<R>(s_tgt, D, ln + 4 * D, ln + 5 * D, D, s_xb, L.XS);
    __syncthreads();
    matvec<R>(p.w_1, p.b_1, F, D, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * F; idx += kThreads) {
      const int r = idx / F, j = idx - r * F;
      const float h = s_buf[r * L.BW + j];
      s_xb[r * L.XS + j] = __float2bfloat16(0.5f * h * (1.0f + erff(h * 0.7071067811865476f)));
    }
    __syncthreads();
    matvec<R>(p.w_2, p.b_2, D, F, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] += s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- final norm, head, greedy pick
    layer_norm_rows<R>(s_tgt, D, ln + 6 * D, ln + 7 * D, D, s_xb, L.XS);
    __syncthreads();
    matvec<R>(p.w_h, p.b_h, C, D, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * C; idx += kThreads) {
      const int r = idx / C, c = idx - r * C;
      if (row0 + r < p.B) p.logits[((size_t)(row0 + r) * n + i) * C + c] = s_buf[r * L.BW + c];
    }
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < R; r += kWarps) {
        float best = -3.402823466e38f;
        int arg = 0x7fffffff;
        for (int c = lane; c < C; c += 32) {
          const float v = s_buf[r * L.BW + c];
          if (v > best) { best = v; arg = c; }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
          if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
        }
        if (lane == 0) s_tok[r] = arg;
      }
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L = make_layout(p, R);
  cudaError_t err = cudaFuncSetAttribute(ar_decode_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return err;
  const int grid = (p.B + R - 1) / R;
  ar_decode_kernel<R><<<grid, kThreads, L.bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). The caller allocates every
// buffer; k_cache/v_cache hold ceil(B / rows_per_block) * rows_per_block rows.
int parseq_ar_decode(const void* mem_k, const void* mem_v, const void* emb,
                     const void* pos_add, const void* pos_q, const void* q_proj,
                     const void* w_kv, const void* b_kv, const void* w_o, const void* b_o,
                     const void* w_cq, const void* b_cq, const void* w_co, const void* b_co,
                     const void* w_1, const void* b_1, const void* w_2, const void* b_2,
                     const void* w_h, const void* b_h, const void* ln,
                     void* logits, void* k_cache, void* v_cache,
                     int B, int M, int D, int H, int n, int C, int F, int bos_id,
                     int rows_per_block, void* stream) {
  if (B < 1 || D != H * kDh || D % 8 || F % 8 || M < 1 || n < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mem_k = static_cast<const bf16*>(mem_k);
  p.mem_v = static_cast<const bf16*>(mem_v);
  p.emb = static_cast<const bf16*>(emb);
  p.pos_add = static_cast<const float*>(pos_add);
  p.pos_q = static_cast<const float*>(pos_q);
  p.q_proj = static_cast<const float*>(q_proj);
  p.w_kv = static_cast<const bf16*>(w_kv);  p.b_kv = static_cast<const float*>(b_kv);
  p.w_o = static_cast<const bf16*>(w_o);    p.b_o = static_cast<const float*>(b_o);
  p.w_cq = static_cast<const bf16*>(w_cq);  p.b_cq = static_cast<const float*>(b_cq);
  p.w_co = static_cast<const bf16*>(w_co);  p.b_co = static_cast<const float*>(b_co);
  p.w_1 = static_cast<const bf16*>(w_1);    p.b_1 = static_cast<const float*>(b_1);
  p.w_2 = static_cast<const bf16*>(w_2);    p.b_2 = static_cast<const float*>(b_2);
  p.w_h = static_cast<const bf16*>(w_h);    p.b_h = static_cast<const float*>(b_h);
  p.ln = static_cast<const float*>(ln);
  p.logits = static_cast<float*>(logits);
  p.k_cache = static_cast<bf16*>(k_cache);
  p.v_cache = static_cast<bf16*>(v_cache);
  p.B = B; p.M = M; p.D = D; p.H = H; p.n = n; p.C = C; p.F = F; p.bos_id = bos_id;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return (int)launch<1>(p, s);
    case 2: return (int)launch<2>(p, s);
    case 4: return (int)launch<4>(p, s);
    case 8: return (int)launch<8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* parseq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
