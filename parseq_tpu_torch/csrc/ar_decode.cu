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
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6,
// experiments/torch_ar_decode_phase_trace.py): every step is a chain of
// seven products of the block's R <= 8 rows with all decoder weights
// (~3.9 MB in bf16: K|V, out, cross q, cross out, MLP 1536 x 384 twice,
// head; L2-resident after the first step) and two attentions, the cross one
// over each row's memory K/V (2 x M x D bf16 = 196 KB at M = 128, D = 384),
// all far below the tensor-core ridge. The products now run at the rate one
// SM streams weights from L2 (~52 B a cycle, ~78k cycles a step whatever R;
// experiments/torch_ar_decode_stream_probe.py); cross-attention, a serial
// loop over keys per (row, head), holds most of a step: ~53k cycles a row in
// a block alone, ~105k a row when 128 blocks share the HBM (62% of a step at
// B = 256, R = 2).
//
// What the design does about it:
//   * The products run on mma.sync m16n8k16 (bf16 -> f32) with the operands
//     swapped: the weight, in torch (out, in) layout, is the A operand (16
//     output features x 16 k, ldmatrix from shared memory); the block's rows
//     are the B operand (k16 x n8: each row's bf16 activation, ldmatrix from
//     s_xb). R <= 8 rows fill one n8 column block; columns past R read a
//     clamped row and are never stored. XS is padded to 8 elements past a
//     multiple of 64 so that the 8 rows' 16-byte chunks hit distinct banks.
//   * A product's rows go in tiles of kTileN = 192, 16 to each warp. Each
//     warp streams its own 16-row slabs (kSliceK = 64 deep, 2 KB, 128-byte
//     swizzle: conflict-free copies and ldmatrix reads) through its own
//     cp.async ring of kStages slabs, and waits only for its own copies (a
//     __syncwarp): a block barrier per slice halved the stream (25.5 against
//     52 B a cycle in the probe). The slab order (product, tile, k-slice) is
//     the same every step and does not depend on the data, so each ring runs
//     continuously over the whole decode: it is never drained between
//     products or steps, and the next product's first slabs load while the
//     block runs its LayerNorm, attention or argmax. The lane's copy
//     addresses are kept in the ring's cursor and advanced, not recomputed
//     (that halved the cycles spent issuing). A warp keeps its m16n8
//     accumulators (even and odd k16 steps apart) in registers across a
//     tile's slabs; the epilogue adds the bias, loaded when the tile starts,
//     and stores from registers. Rows past N (the head's 95 of 96) and k past
//     K are zero-filled copies; a warp with no rows in a product (6 of 12 in
//     the head) skips it and prefetches the next.
//   * R batch rows per block (template: 1, 2, 4, 8); the wrapper's policy
//     (ops/ar_kernel.py:rows_per_block) is the card's B x R table. Ragged
//     last block: rows past B are computed on a clamped memory row and never
//     stored.
//   * Activations (residual stream, product inputs/outputs, probabilities)
//     live in shared memory; the K/V cache is global scratch owned by the
//     block (L2-resident), written and read back after __syncthreads.
//   * Attention: one warp per (row, head); dh == 32 is one lane per channel.
//     Scores: one lane per key, 16-byte loads of the key's 32 channels.
//     Keys 0..i are looped directly (no -1e9 mask); the embedding row is
//     indexed (no one-hot matmul); C = 95 classes are handled directly
//     (no 128-lane padding). Argmax takes the lowest index on ties.
// Not done yet, in the order the trace ranks them: attention on mma (or its
// PV loop vectorised), weights split across a thread-block cluster (so that
// B < 132 uses every SM and each SM streams less), TMA, wgmma, prepare()'s
// weights kept between calls, batch early exit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 32;               // head width handled by one warp
constexpr int kTileN = 16 * kWarps;   // output features of a product tile: 16 rows a warp
constexpr int kSliceK = 64;           // k of a ring slab: 128 bytes of each weight row
constexpr int kStageElems = 16 * kSliceK;  // a warp's slab: its 16 rows x kSliceK
constexpr int kStages = 4;            // slabs in each warp's ring (a power of 2)
constexpr int kProducts = 7;          // a step's products, in ring order:
enum { kKV, kO, kCQ, kCO, kM1, kM2, kHead };

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
  int BW, XS, SCW;                         // row strides: product out, product in, probs
  size_t ring, tgt, buf, cq, q, sc, xb, tok, bytes;  // byte offsets
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline Layout make_layout(const Params& p, int R) {
  Layout L;
  L.BW = imax(imax(2 * p.D, p.F), p.C) + 4;  // + 4: the epilogue's 4 columns on distinct banks
  L.XS = ceil_div(imax(p.D, p.F), kSliceK) * kSliceK + 8;  // + 8: see the header
  L.SCW = imax(p.M, p.n);
  size_t off = 0;
  L.ring = off; off += sizeof(bf16) * kWarps * kStages * kStageElems;
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

// (N, K) of product pi and its weight, (N, K) bf16 row-major in global memory.
__device__ __forceinline__ void product_dims(const Params& p, int pi, int& N, int& K) {
  N = pi == kKV ? 2 * p.D : pi == kM1 ? p.F : pi == kHead ? p.C : p.D;
  K = pi == kM2 ? p.F : p.D;
}

__device__ __forceinline__ const bf16* product_weight(const Params& p, int pi) {
  switch (pi) {
    case kKV: return p.w_kv;
    case kO: return p.w_o;
    case kCQ: return p.w_cq;
    case kCO: return p.w_co;
    case kM1: return p.w_1;
    case kM2: return p.w_2;
    default: return p.w_h;
  }
}

__device__ __forceinline__ const float* product_bias(const Params& p, int pi) {
  switch (pi) {
    case kKV: return p.b_kv;
    case kO: return p.b_o;
    case kCQ: return p.b_cq;
    case kCO: return p.b_co;
    case kM1: return p.b_1;
    case kM2: return p.b_2;
    default: return p.b_h;
  }
}

// Tiles of product (N rows) that hold rows of `warp`: warp w computes rows
// t * kTileN + 16 w .. + 15 of tile t.
__device__ __forceinline__ int warp_tiles(int N, int warp) {
  return N > 16 * warp ? ceil_div(N - 16 * warp, kTileN) : 0;
}

// A warp's weight ring: kStages slabs of its 16 rows x kSliceK of a product
// tile, each row 128 bytes in the 128-byte swizzle (16-byte chunk c of row r
// at c ^ (r % 8)). Each warp streams and consumes its own slabs, so a slab
// waits only for the warp's own copies (a __syncwarp), never for the block.
// Lane l copies chunk c = l % 8 of rows l / 8 + 4u (u = 0..3) of a slab.
// Every lane keeps this state; the cursor fields describe the next slab to
// issue.
struct Ring {
  bf16* base;          // this warp's kStages slabs
  const bf16* src;     // the lane's chunk of row u = 0 in the next slab
  int row_stride;      // 4 weight rows, in elements
  int kcol, K;         // the lane's chunk's k in the next slab; the product's K
  int rows_ok;         // bit u: row u of the lane is inside the product
  int ks_left;         // slabs left in the current tile
  int tiles_left;      // tiles of the product left to this warp, the current one included
  int pi, j0;          // product and first row (of the warp) of the current tile
  int left;            // slabs still to issue in the whole decode
  int put, take;       // the stages the next issue fills and the next product slab reads
  int dst0, dst1;      // swizzled offsets of the lane's chunks of rows u = 0 and 1
};

// The next product after pi, cyclically, in which `warp` has rows (the
// caller ensures there is one).
__device__ int next_product(const Params& p, int pi, int warp) {
  int N, K;
  do {
    pi = pi + 1 == kProducts ? 0 : pi + 1;
    product_dims(p, pi, N, K);
  } while (warp_tiles(N, warp) == 0);
  return pi;
}

// Points the ring's cursor at the first slab of the tile whose first warp
// row is j0 in product g.pi.
__device__ __forceinline__ void ring_tile(const Params& p, Ring& g) {
  const int lane = threadIdx.x & 31;
  int N, K;
  product_dims(p, g.pi, N, K);
  const int r0 = g.j0 + (lane >> 3), c = lane & 7;
  g.K = K;
  g.row_stride = 4 * K;
  g.kcol = 8 * c;
  g.src = product_weight(p, g.pi) + (size_t)r0 * K + 8 * c;
  g.rows_ok = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) g.rows_ok |= (r0 + 4 * u < N) << u;
  g.ks_left = ceil_div(K, kSliceK);
}

// The cursor at the next tile of this warp, or the first tile of the next
// product that has rows of it.
__device__ __forceinline__ void ring_next_tile(const Params& p, Ring& g) {
  const int warp = threadIdx.x >> 5;
  if (--g.tiles_left > 0) {
    g.j0 += kTileN;
  } else {
    g.pi = next_product(p, g.pi, warp);
    int N, K;
    product_dims(p, g.pi, N, K);
    g.tiles_left = warp_tiles(N, warp);
    g.j0 = 16 * warp;
  }
  ring_tile(p, g);
}

__device__ Ring make_ring(const Params& p, bf16* ring_smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Ring g;
  g.base = ring_smem + warp * kStages * kStageElems;
  g.put = g.take = 0;
  g.dst0 = sw128_at(lane >> 3, lane & 7);
  g.dst1 = sw128_at(4 + (lane >> 3), lane & 7);
  int slabs = 0;
  for (int pi = 0; pi < kProducts; ++pi) {
    int N, K;
    product_dims(p, pi, N, K);
    slabs += warp_tiles(N, warp) * ceil_div(K, kSliceK);
  }
  g.left = p.n * slabs;
  g.pi = kProducts - 1;
  g.tiles_left = 1;
  if (g.left > 0) ring_next_tile(p, g);  // the first tile of the first product with rows here
  return g;
}

// Issues the copies of the warp's next slab into stage `put` and commits
// them as one group (an empty group once every slab of the decode is
// issued), then advances the cursor in the order the products consume the
// slabs. Rows past N and k past K are zero-filled.
__device__ __forceinline__ void issue_slab(const Params& p, Ring& g) {
  if (g.left > 0) {
    bf16* st = g.base + g.put * kStageElems;
    const bool k_ok = g.kcol < g.K;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cp_async16(st + (u & 1 ? g.dst1 : g.dst0) + (u >> 1) * 8 * kSliceK,
                 g.src + u * g.row_stride, k_ok && (g.rows_ok >> u & 1));
    g.src += kSliceK;
    g.kcol += kSliceK;
    if (--g.left > 0 && --g.ks_left == 0) ring_next_tile(p, g);
  }
  cp_async_commit();
  g.put = (g.put + 1) & (kStages - 1);
}

// Product pi of the step: out[r, j] = sum_k x[r, k] W[j, k] + bias[j] for
// rows r < R and j < N, with x bf16 in shared memory (row stride xs, k up to
// K rounded to kSliceK readable and finite) and out f32 in shared memory
// (row stride os). Each warp consumes its slabs of the product from its
// ring and issues the slab kStages - 1 ahead; the caller's block barriers
// bracket the product.
template <int R>
__device__ void product(const Params& p, int pi, Ring& g, const bf16* x, int xs, float* out,
                        int os) {
  int N, K;
  product_dims(p, pi, N, K);
  const float* __restrict__ bias = product_bias(p, pi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = warp_tiles(N, warp), kslices = ceil_div(K, kSliceK);
  // ldmatrix rows of the B operand: lanes 8m .. 8m + 7 give k 8m .. 8m + 7 of
  // rows 0..7 (clamped to the block's R).
  const bf16* xrow = x + min(lane & 7, R - 1) * xs + (lane >> 3) * 8;
  // ldmatrix rows of the A operand: lanes 0-15 rows 0-15 of the slab at k 0-7,
  // lanes 16-31 the same rows at k 8-15; k16 step kk at chunk 2 kk + achunk.
  const int arow = lane & 15, achunk = lane >> 4;
  int aoff[kSliceK / 16];
#pragma unroll
  for (int kk = 0; kk < kSliceK / 16; ++kk) aoff[kk] = sw128_at(arow, 2 * kk + achunk);
  for (int t = 0; t < tiles; ++t) {
    // acc: (feature j, row r), (j, r + 1), (j + 8, r), (j + 8, r + 1).
    const int j = t * kTileN + 16 * warp + (lane >> 2), r = 2 * (lane & 3);
    const float bias_j = j < N ? bias[j] : 0.f, bias_j8 = j + 8 < N ? bias[j + 8] : 0.f;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even, odd k16 steps
    for (int s = 0; s < kslices; ++s) {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      issue_slab(p, g);
      const bf16* st = g.base + g.take * kStageElems;
      uint32_t b[2][4];
      ldmatrix_x4(b[0], xrow + s * kSliceK);
      ldmatrix_x4(b[1], xrow + s * kSliceK + 32);
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, st + aoff[kk]);
        mma_bf16(acc[kk & 1], a, b[kk >> 1][2 * (kk & 1)], b[kk >> 1][2 * (kk & 1) + 1]);
      }
      g.take = (g.take + 1) & (kStages - 1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int je = j + 8 * (e >> 1), re = r + (e & 1);
      if (re < R && je < N) out[re * os + je] = acc[0][e] + acc[1][e] + (e >> 1 ? bias_j8 : bias_j);
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
  extern __shared__ __align__(128) unsigned char smem[];
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
  // Product inputs read k up to K rounded to kSliceK: finite from the start.
  for (int idx = tid; idx < R * L.XS; idx += kThreads) s_xb[idx] = __float2bfloat16(0.f);

  Ring ring = make_ring(p, reinterpret_cast<bf16*>(smem + L.ring));
  for (int s = 0; s < kStages - 1; ++s) issue_slab(p, ring);
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
    product<R>(p, kKV, ring, s_xb, L.XS, s_buf, L.BW);
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
    product<R>(p, kO, ring, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] = p.pos_q[i * D + d] + s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- cross-attention to memory
    layer_norm_rows<R>(s_tgt, D, ln + 2 * D, ln + 3 * D, D, s_xb, L.XS);
    __syncthreads();
    product<R>(p, kCQ, ring, s_xb, L.XS, s_cq, D);
    __syncthreads();
    attend<R>(s_cq, D, mk, mv, M, D, p.H, s_sc, L.SCW, s_xb, L.XS);
    __syncthreads();
    product<R>(p, kCO, ring, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] += s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- MLP with exact-erf GELU
    layer_norm_rows<R>(s_tgt, D, ln + 4 * D, ln + 5 * D, D, s_xb, L.XS);
    __syncthreads();
    product<R>(p, kM1, ring, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * F; idx += kThreads) {
      const int r = idx / F, j = idx - r * F;
      const float h = s_buf[r * L.BW + j];
      s_xb[r * L.XS + j] = __float2bfloat16(0.5f * h * (1.0f + erff(h * 0.7071067811865476f)));
    }
    __syncthreads();
    product<R>(p, kM2, ring, s_xb, L.XS, s_buf, L.BW);
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      s_tgt[idx] += s_buf[r * L.BW + d];
    }
    __syncthreads();
    // ---- final norm, head, greedy pick
    layer_norm_rows<R>(s_tgt, D, ln + 6 * D, ln + 7 * D, D, s_xb, L.XS);
    __syncthreads();
    product<R>(p, kHead, ring, s_xb, L.XS, s_buf, L.BW);
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
