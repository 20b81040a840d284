// All pre-LN ViT blocks of an encoder in one launch, for Hopper (sm_90a):
// kernel B5 of the port.
//
// Replaces the Pallas TPU kernel
// parseq_tpu/ops/encoder_kernel.py:_encoder_kernel (wrapper
// fused_encoder_blocks), whose one caller in the JAX package is the encoder
// microbench experiments/encoder_kernel_bench.py (PARSeq-S: L = 128 tokens,
// D = 384, 6 heads, MLP 1536, 12 layers, batch 256, bf16). For every image
// and every layer, with that kernel's rounding points:
//   h   = bf16(LN1_f32(x))
//   qkv = bf16(bf16(h Wqkv^T) + bqkv)                        f32 sums
//   per head: s = f32(q k^T) * scale, p = bf16(softmax_f32(s)) (normalised
//             before the cast), o = bf16(sum_j p_j v_j)      f32 sums
//   x1  = bf16(x + bf16(bf16(o Wo^T) + bo))
//   h2  = bf16(LN2_f32(x1))
//   hid = bf16(gelu_erf(bf16(bf16(h2 W1^T) + b1)))           GELU in f32
//   out = bf16(x1 + bf16(bf16(hid W2^T) + b2))
//
// What bounds it on this card: at the PARSeq-S shape above it does 1.469
// TFLOP (115.96 GFLOP of matrix products and 6.44 GFLOP of attention per
// layer), 1.49 ms at the bf16 tensor-core peak, and must move only ~93 MB
// (the activations in and out and 42.5 MB of weights), 28 us at 3.35 TB/s:
// it is bound by operations. This design is held further back by what its
// blocks fetch from L2: every block streams every weight (3.5 MB a layer)
// and restages its A operand for each 128-column tile (3.45 MB a layer),
// 21.3 GB a call at B = 256; and by 128 registers a thread, the most that
// lets two blocks share an SM so that one block's loads, epilogues and
// softmax overlap the other's products.
// experiments/torch_encoder_phase_trace.py gives the cycles of each phase.
//
// What the design does about it:
//   * One block of 8 warps per image loops over all layers, so the whole
//     encoder is one launch. The residual stream lives in the output tensor
//     (96 KB per image, 25 MB at B = 256) and the LayerNorm output h and the
//     packed q|k|v projection, later the attention output (over the q
//     columns) and the MLP hidden, in per-image scratch: L2-resident as far
//     as the 50 MB L2 holds them, since each block rereads what it wrote a
//     phase earlier. Per-layer weights (3.5 MB) are shared by all blocks
//     through L2.
//   * All four products go through one routine, gemm: the two warpgroups
//     take rows 0-63 and 64-127 of a 128 x 128 output tile, each with
//     wgmma m64n128k16 on operands in shared memory (bf16 in, f32 sums in
//     64 registers a thread). One 3-stage cp.async ring of 64-deep A and W
//     slices in the 128-byte swizzle (W read K-major in torch's (out, in)
//     layout) runs over all tiles of the product without draining between
//     them. A tile's sums, rounded to bf16, go through the ring slot its
//     last slice used, so that the epilogue (bias, GELU or residual add,
//     with the rounding points above) moves 16 bytes a thread.
//   * Attention takes one head at a time on its 64-column slice (the TPU
//     kernel's head-masked full-width products are a Mosaic workaround; the
//     sums are the same). K and V^T are staged in shared memory; each warp
//     keeps its 16 query rows' whole score rows (L <= 128) in registers
//     (mma.sync m16n8k16), so softmax uses the exact row max and sum, and
//     the normalised probabilities, packed to bf16 pairs, are the A
//     fragments of the PV product.
//   * GELU uses erff (the TPU kernel's rational erf is a Mosaic workaround).
// Shared memory: 96 KB per block (the ring; attention reuses 35 KB of it),
// two blocks per SM, so all 256 images of a PARSeq-S batch run in one wave.
// Not done yet: weights shared between blocks (TMA multicast to a cluster)
// instead of fetched by each, the epilogue (GELU above all) overlapped
// with the next tile's products, LayerNorm fused into the epilogue before
// it, attention on wgmma, h or the hidden kept on chip, L > 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxL = 128;    // tokens per image: 8 warps x 16 query rows, one 128-row tile
constexpr int kMaxD = 512;    // LayerNorm keeps a row in registers (16 values per lane)
constexpr int kDh = 64;       // head width
constexpr int kBM = 128;      // product rows (all tokens of the image): warpgroup w has 64w..64w+63
constexpr int kBN = 128;      // product tile columns: one wgmma m64n128 per warpgroup and k-step
constexpr int kBK = 64;       // product depth of a ring stage
constexpr int kStages = 3;
constexpr int kKC = kBK / 8;  // 16-byte chunks of a staged 128-byte row
constexpr int kSlice = kBM * kBK;  // bf16 of one staged A or W slice (16 KB)
constexpr int kKS = kDh + 8;  // bf16 row stride of staged K
constexpr int kVS = kMaxL + 8;  // bf16 row stride of staged V^T
constexpr size_t kGemmSmem = sizeof(bf16) * kStages * 2 * kSlice;        // 98,304 B
constexpr size_t kAttnSmem = sizeof(bf16) * (kMaxL * kKS + kDh * kVS);  // 35,840 B
constexpr size_t kSmem = kGemmSmem > kAttnSmem ? kGemmSmem : kAttnSmem;

struct Params {
  const bf16* x;    // (B, L, D) input
  bf16* out;        // (B, L, D): the residual stream, updated in place
  bf16* h;          // (B, L, D) scratch: LayerNorm output
  bf16* big;        // (B, L, ldb) scratch: q|k|v, then attention out, then MLP hidden
  const float* ln1_s;
  const float* ln1_b;
  const float* ln2_s;
  const float* ln2_b;   // (depth, D) each
  const bf16* wqkv;     // (depth, 3D, D)
  const bf16* bqkv;     // (depth, 3D)
  const bf16* wo;       // (depth, D, D)
  const bf16* bo;       // (depth, D)
  const bf16* w1;       // (depth, F, D)
  const bf16* b1;       // (depth, F)
  const bf16* w2;       // (depth, D, F)
  const bf16* b2;       // (depth, D)
  int L, D, H, F, depth, ldb;
  float scale;
};

// threadIdx.x read afresh: what a phase derives from it (offsets, masks) is
// computed in that phase and not held in registers across the whole layer
// loop, where the attention phase needs them all.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r] = bf16(LN_f32(src[r]) * s + b) for rows r < L, one warp per row.
__device__ void layer_norm(const bf16* src, bf16* dst, const float* s, const float* b, int L,
                           int D) {
  const int tid = thread_index(), warp = tid >> 5, lane = tid & 31;
  const int pairs = D / 64;  // bf16 pairs per lane
  for (int r = warp; r < L; r += kWarps) {
    const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(src + (size_t)r * D);
    float2 v[kMaxD / 64];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 64; ++i) {
      if (i < pairs) {
        v[i] = __bfloat1622float2(row[lane + 32 * i]);
        sum += v[i].x + v[i].y;
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 64; ++i) {
      if (i < pairs) {
        const float a = v[i].x - mean, c = v[i].y - mean;
        sq += a * a + c * c;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D);
#pragma unroll
    for (int i = 0; i < kMaxD / 64; ++i) {
      if (i < pairs) {
        const int c = 2 * (lane + 32 * i);
        out[lane + 32 * i] = __floats2bfloat162_rn((v[i].x - mean) * rstd * s[c] + b[c],
                                                   (v[i].y - mean) * rstd * s[c + 1] + b[c + 1]);
      }
    }
  }
}

// 8 bf16 at p (16-byte aligned) as floats, and 8 floats rounded to bf16 at p.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// What a product does with t = bf16(bf16(A W^T) + bias), the rounding
// points of every product of the layer: out = t (q|k|v), out = bf16(GELU(t))
// (the MLP hidden) or out = bf16(out + t) (the residual stream).
enum class Epilogue { kStore, kGelu, kResidual };

// The product for the image's rows r < L: A is (L, K) bf16 with row stride
// lda, W is (N, K) bf16 row-major (torch's (out, in) layout, K-major as
// wgmma's B), bias (N) bf16, out (L, N) bf16 with row stride ldo; N % kBN
// == 0 and K % kBK == 0.
//
// One cp.async ring of kStages 64-deep slices (A's 128 rows and W's 128
// rows of the tile, both in the 128-byte swizzle) runs over all (N tile,
// k-slice) steps of the product in order, so the next tile's first slices
// land while the current tile finishes and its epilogue runs: nothing
// drains between tiles. Warpgroup w multiplies rows 64w..64w+63 by the
// tile's W slice with wgmma m64n128k16 (4 a slice) and waits for them; a
// warpgroup whose rows all lie past L only stages. Rows past L are staged
// as zeros. A tile's products, rounded to bf16, go through the ring slot
// of its last slice (free once both warpgroups' wgmmas are done) so that
// the epilogue reads and writes global memory 16 bytes a thread, whole
// 256-byte rows a warp. Ends with a block barrier: the outputs are visible
// and the ring is free.
template <Epilogue E>
__device__ void gemm(unsigned char* smem, const bf16* A, int lda, const bf16* W, const bf16* bias,
                     int N, int K, int L, bf16* out, int ldo) {
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = thread_index(), warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wtid = tid & 127, g = lane >> 2, tg = lane & 3;
  const bool active = wg * 64 < L;
  const int KT = K / kBK, steps = N / kBN * KT;
  auto slot = [&](int s) { return ring + (s % kStages) * 2 * kSlice; };
  // Copy u of a thread stages row (tid + 256 u) / 8, chunk tid % 8 of each
  // slice: a warp covers 4 whole 128-byte rows per copy, and the swizzle
  // spreads its 16-byte stores over all 32 banks four times.
  const int sc = tid & 7;
  auto load = [&](int s) {
    bf16* sa = slot(s);
    bf16* sw = sa + kSlice;
    const int n0 = s / KT * kBN, k0 = s % KT * kBK + 8 * sc;
#pragma unroll
    for (int u = 0; u < kBM * kKC / kThreads; ++u) {
      const int r = (tid >> 3) + u * (kThreads / kKC);
      cp_async16(sa + sw128_at(r, sc), A + (size_t)(r < L ? r : 0) * lda + k0, r < L);
      cp_async16(sw + sw128_at(r, sc), W + (size_t)(n0 + r) * K + k0, true);
    }
  };
  // Set here, though every tile's first product overwrites it: the epilogue
  // reads acc on a path where a warpgroup that skipped its products would
  // meet it unset, and the compiler would keep all 64 registers live across
  // the other phases of the layer (attention needs them).
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  // Ring step s: slice s lands, slice s + 2 goes into slice s - 1's slot
  // (issued before the products, so that nothing but wgmmas sits between
  // their fence and their wait), and the warpgroup's products on slice s
  // run; a tile's first step overwrites acc.
  auto step = [&](int s, auto accumulate) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice s have landed
    fence_proxy_async();           // ... and are visible to wgmma
    __syncthreads();               // everyone's have; slice s - 1's wgmmas are done
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();
    if (active) {
      const bf16* sa = slot(s) + sw128_at(64 * wg, 0);
      const bf16* sw = slot(s) + kSlice;
      wgmma_fence();
      wgmma_ss128<decltype(accumulate)::value>(acc, wgmma_desc_sw128(sa, 1024),
                                               wgmma_desc_sw128(sw, 1024));
#pragma unroll
      for (int ks = 1; ks < kBK / 16; ++ks)
        wgmma_ss128<true>(acc, wgmma_desc_sw128(sa + 16 * ks, 1024),
                          wgmma_desc_sw128(sw + 16 * ks, 1024));
      wgmma_commit_and_wait();
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int n0 = 0, s = 0; n0 < N; n0 += kBN) {
    step(s++, std::false_type());
    for (int kt = 1; kt < KT; ++kt) step(s++, std::true_type());
    __syncthreads();  // both warpgroups' wgmmas are done with the slot
    // Warpgroup w's 64 x 128 products in its half of the slot: 256-byte
    // rows, 16-byte chunk j of row r at chunk j ^ (r % 8). Warp w % 4 holds
    // rows 16 (w % 4) + g and + 8, columns 8j + 2tg + {0, 1} at acc[4j +
    // {0, 1}] and acc[4j + {2, 3}].
    bf16* tile = slot(s - 1) + wg * kSlice;
    if (active) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * (warp & 3) + g + 8 * hf;
          *reinterpret_cast<uint32_t*>(tile + r * kBN + ((j ^ (r & 7)) << 3) + 2 * tg) =
              pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
    }
    bar_sync(1 + wg, kThreads / 2);
    if (active) {
      // A thread takes chunk c = wtid % 16 of rows wtid / 16 + 8i: one bias
      // chunk, and whole 256-byte rows a warp.
      constexpr int kChunks = kBN / 8, kRowStep = kThreads / 2 / kChunks;
      const int c = wtid % kChunks, rows = min(L - 64 * wg, 64);
      bf16* dst = out + (size_t)(64 * wg) * ldo + n0 + 8 * c;
      float bb[8];
      load8(bias + n0 + 8 * c, bb);
#pragma unroll 1
      for (int r = wtid / kChunks; r < rows; r += kRowStep) {
        float t[8];
        load8(tile + r * kBN + ((c ^ (r & 7)) << 3), t);
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = round_bf16(t[e] + bb[e]);
        bf16* o = dst + (size_t)r * ldo;
        if constexpr (E == Epilogue::kGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) t[e] = gelu_erf(t[e]);
        } else if constexpr (E == Epilogue::kResidual) {
          float v[8];
          load8(o, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) t[e] += v[e];
        }
        store8(o, t);
      }
    }
  }
  __syncthreads();
}

// Self-attention of one image, one head at a time: q, k, v are the column
// blocks [0, D), [D, 2D), [2D, 3D) of `big` (row stride ldb). Head hd's
// output overwrites its own q columns: each warp reads its 16 query rows
// into registers before it writes those rows, and no other warp reads them.
__device__ void attention(unsigned char* smem, bf16* big, int ldb, int L, int D, int H,
                          float scale) {
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  unsigned short* s_vt = reinterpret_cast<unsigned short*>(smem + sizeof(bf16) * kMaxL * kKS);
  const bf16* vt = reinterpret_cast<const bf16*>(s_vt);
  const int tid = thread_index(), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int Lp = (L + 15) & ~15;  // keys padded to a multiple of 16 with zero rows
  const int ra = warp * 16 + g, rb = ra + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int hd = 0; hd < H; ++hd) {
    const bf16* kb = big + D + hd * kDh;
    const bf16* vb = big + 2 * D + hd * kDh;
    // Chunk idx -> key j = idx % Lp, channels c*8..c*8+7 with c = idx / Lp:
    // neighbouring lanes take neighbouring keys, so the 16-bit V^T stores of
    // a warp hit consecutive words.
    for (int idx = tid; idx < Lp * 8; idx += kThreads) {
      const int c = idx / Lp, j = idx - c * Lp;
      uint4 kv = zero, vv = zero;
      if (j < L) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)j * ldb + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)j * ldb + c * 8);
      }
      *reinterpret_cast<uint4*>(s_k + j * kKS + c * 8) = kv;
      const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_vt[(c * 8 + 2 * e) * kVS + j] = (unsigned short)(w[e] & 0xffffu);
        s_vt[(c * 8 + 2 * e + 1) * kVS + j] = (unsigned short)(w[e] >> 16);
      }
    }
    __syncthreads();

    if (warp * 16 < L) {
      bf16* qa = big + (size_t)(ra < L ? ra : 0) * ldb + hd * kDh + 2 * tg;
      bf16* qb = big + (size_t)(rb < L ? rb : 0) * ldb + hd * kDh + 2 * tg;
      uint32_t qf[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int d = ks * 16;
        qf[ks][0] = ra < L ? ld32(qa + d) : 0u;
        qf[ks][1] = rb < L ? ld32(qb + d) : 0u;
        qf[ks][2] = ra < L ? ld32(qa + d + 8) : 0u;
        qf[ks][3] = rb < L ? ld32(qb + d + 8) : 0u;
      }
      // Scores of rows ra (s[.][0..1]) and rb (s[.][2..3]), keys nt*8 + 2tg + {0, 1}.
      float s[kMaxL / 8][4];
#pragma unroll
      for (int nt = 0; nt < kMaxL / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (nt * 8 < Lp) {
          const bf16* kr = s_k + (nt * 8 + g) * kKS + 2 * tg;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) mma_bf16(s[nt], qf[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
        }
      }
      float ma = -3.402823466e38f, mb = -3.402823466e38f;
#pragma unroll
      for (int nt = 0; nt < kMaxL / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = nt * 8 + 2 * tg + e < L;
          s[nt][e] = valid ? s[nt][e] * scale : -3.402823466e38f;
          s[nt][2 + e] = valid ? s[nt][2 + e] * scale : -3.402823466e38f;
          ma = fmaxf(ma, s[nt][e]);
          mb = fmaxf(mb, s[nt][2 + e]);
        }
      }
      // The four lanes of a quad hold one row's columns.
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMaxL / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = nt * 8 + 2 * tg + e < L;
          s[nt][e] = valid ? expf(s[nt][e] - ma) : 0.f;
          s[nt][2 + e] = valid ? expf(s[nt][2 + e] - mb) : 0.f;
          suma += s[nt][e];
          sumb += s[nt][2 + e];
        }
      }
      suma += __shfl_xor_sync(0xffffffffu, suma, 1);
      suma += __shfl_xor_sync(0xffffffffu, suma, 2);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, 1);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, 2);

      // The normalised probabilities of rows ra and rb as bf16 pairs: half
      // the registers of the f32 scores, which end here.
      uint32_t pr[kMaxL / 8][2];
#pragma unroll
      for (int nt = 0; nt < kMaxL / 8; ++nt) {
        pr[nt][0] = pack_bf16(s[nt][0] / suma, s[nt][1] / suma);
        pr[nt][1] = pack_bf16(s[nt][2] / sumb, s[nt][3] / sumb);
      }
      // O = P V: the probabilities of n8 tiles 2kk and 2kk+1 are the A
      // fragment of k-step kk.
      float o[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxL / 16; ++kk) {
        if (kk * 16 < Lp) {
          const uint32_t pa[4] = {pr[2 * kk][0], pr[2 * kk][1], pr[2 * kk + 1][0],
                                  pr[2 * kk + 1][1]};
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const bf16* vr = vt + (nt * 8 + g) * kVS + kk * 16 + 2 * tg;
            mma_bf16(o[nt], pa, ld32(vr), ld32(vr + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (ra < L)
          *reinterpret_cast<__nv_bfloat162*>(qa + nt * 8) = __floats2bfloat162_rn(o[nt][0], o[nt][1]);
        if (rb < L)
          *reinterpret_cast<__nv_bfloat162*>(qb + nt * 8) = __floats2bfloat162_rn(o[nt][2], o[nt][3]);
      }
    }
    __syncthreads();  // K and V^T of the next head overwrite this one's
  }
}

__global__ void __launch_bounds__(kThreads, 2) encoder_blocks_kernel(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int L = p.L, D = p.D, F = p.F, ldb = p.ldb;
  const size_t b = blockIdx.x;
  bf16* x = p.out + b * L * D;
  bf16* h = p.h + b * L * D;
  bf16* big = p.big + b * L * ldb;
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.x + b * L * D);
    uint4* dst = reinterpret_cast<uint4*>(x);
    for (int i = threadIdx.x; i < L * D / 8; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();

  for (int l = 0; l < p.depth; ++l) {
    const bf16* bqkv = p.bqkv + (size_t)l * 3 * D;
    const bf16* bo = p.bo + (size_t)l * D;
    const bf16* b1 = p.b1 + (size_t)l * F;
    const bf16* b2 = p.b2 + (size_t)l * D;
    layer_norm(x, h, p.ln1_s + (size_t)l * D, p.ln1_b + (size_t)l * D, L, D);
    __syncthreads();
    gemm<Epilogue::kStore>(smem, h, D, p.wqkv + (size_t)l * 3 * D * D, bqkv, 3 * D, D, L, big, ldb);
    attention(smem, big, ldb, L, D, p.H, p.scale);
    gemm<Epilogue::kResidual>(smem, big, ldb, p.wo + (size_t)l * D * D, bo, D, D, L, x, D);

    layer_norm(x, h, p.ln2_s + (size_t)l * D, p.ln2_b + (size_t)l * D, L, D);
    __syncthreads();
    gemm<Epilogue::kGelu>(smem, h, D, p.w1 + (size_t)l * F * D, b1, F, D, L, big, ldb);
    gemm<Epilogue::kResidual>(smem, big, ldb, p.w2 + (size_t)l * D * F, b2, D, F, L, x, D);
  }
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). All tensors contiguous with
// 16-byte aligned starts: x, out (B, L, D) bf16; scratch h (B, L, D) and big
// (B, L, max(3D, F)) bf16; ln* (depth, D) f32; w* in torch's (out, in)
// layout and b* (depth, out) bf16, depth-stacked. L <= 128, D == 64 * H,
// D and F multiples of 128, D <= 512.
int parseq_encoder_blocks(const void* x, void* out, void* h, void* big, const void* ln1_s,
                          const void* ln1_b, const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2_s, const void* ln2_b, const void* w1,
                          const void* b1, const void* w2, const void* b2, int B, int L, int D,
                          int H, int F, int depth, float scale, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || H < 1 || D != H * kDh || D % kBN || D > kMaxD || F < kBN ||
      F % kBN || depth < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, out, h, big, ln1_s, ln1_b, wqkv, bqkv, wo, bo, ln2_s, ln2_b, w1, b1, w2, b2};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.h = static_cast<bf16*>(h);
  p.big = static_cast<bf16*>(big);
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.ln2_s = static_cast<const float*>(ln2_s);
  p.ln2_b = static_cast<const float*>(ln2_b);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.wo = static_cast<const bf16*>(wo);
  p.bo = static_cast<const bf16*>(bo);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.L = L;
  p.D = D;
  p.H = H;
  p.F = F;
  p.depth = depth;
  p.ldb = 3 * D > F ? 3 * D : F;
  p.scale = scale;
  cudaError_t err = cudaFuncSetAttribute(encoder_blocks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  encoder_blocks_kernel<<<B, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int parseq_encoder_blocks_max_len() { return kMaxL; }

const char* parseq_encoder_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
