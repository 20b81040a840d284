// Unmasked multi-head self-attention for Hopper (sm_90a): kernel B2 of the
// port on the unsplit (B, L, D) layout and, through a second entry, kernel
// B3 on the head-split (BH, L, 64) layout. One kernel design behind both,
// instantiated for bf16 and for f32 operands.
//
// Replaces the Pallas TPU kernels
//   B2 parseq_tpu/ops/attention.py:_pallas_attention_nosplit (wrapper
//      fused_attention_nosplit), which the JAX package runs for every
//      encoder self-attention with L >= KERNEL_MIN_LEN = 192: ViTSTR (L=197,
//      6 heads, D=384), PARSeq patch16-224 (L=196, 6 heads, D=384) and
//      ABINet's vision transformer (L=256, 8 heads, D=512);
//   B3 parseq_tpu/ops/attention.py:_pallas_attention (wrapper
//      fused_attention): q, k, v (BH, L, dh), one head per batch row; its
//      heads_per_block grouping is a VMEM blocking choice, not carried over.
// Both compute, for batch row b, head h and query i, at the TPU kernels'
// rounding points:
//   s_j = (sum_d q[i,d] * k[j,d]) * scale        f32 sums of products
//   p_j = exp(s_j - max s) / sum exp(...)        f32, exact row max and sum,
//                                                normalised before the cast
//   o   = sum_j T(p_j) * v[j,:]                  f32 sums, stored as T
// T is bf16 or f32 (q, k, v, o of one type). No online softmax: it would
// round unnormalised probabilities elsewhere.
//
// What bounds it on this card: q, k, v in and o out, 4*B*L*D*2 bytes in
// bf16, against 4*B*h*L^2*64 FLOP of products:
//   ViTSTR        (256, 197, 6, 384)  155 MB, 46 us; 15.3 GFLOP, 15 us at the
//                                     bf16 tensor-core peak
//   patch16-224   (256, 196, 6, 384)  154 MB, 46 us; 15.1 GFLOP, 15 us
//   ABINet        (256, 256, 8, 512)  268 MB, 80 us; 34.4 GFLOP, 35 us
//   B3            (1536, 128, 64)     101 MB, 30 us;  6.4 GFLOP, 6.5 us
// Bytes bind at every user shape. In f32 the products run on the CUDA cores
// (TF32 would keep about three digits): 15.3 GFLOP at 67 TFLOP/s is 228 us
// at ViTSTR's shape, so f32 is bound by operations.
//
// The design, against what held the first version of this kernel back:
//   1. K and V once per (batch row, head) [it restaged them for each query
//      tile]: one block, one warpgroup of 4 warps, owns a head and walks its
//      16-row query slices 64 rows (4 slices, one a warp) at a time. (b, h)
//      is on grid x, so there is no grid-z limit and B3 is one launch. When
//      B*H is below twice the SM count (B = 1 or 7 at 6 heads) a head's
//      slices are split over up to ceil(slices / 4) blocks, each of which
//      stages K and V once.
//   2. Asynchronous copies [plain loads, a barrier, a scalar V transpose]:
//      K, then V, then each warp's next Q slice come in through 16-byte
//      cp.async copies, zero-filled past L, so V lands while the first
//      scores are computed and Q slice n+1 while slice n is. K and V are
//      laid out as wgmma core matrices (8 rows x 16 bytes); V stays in its
//      row-major form and PV reads it transposed by the descriptor. Shared
//      memory: 61 KB at L=197, 41 KB at L=128, 73 KB at L=256 (it was
//      112-137 KB). A tensor map (TMA) was not tried: each call would
//      encode three maps for the strided views, and what the staging costs
//      is the wait for K at a block's start (below), which a copy engine
//      does not shorten.
//   3. Scores in registers [f32 rows in shared memory, softmax one row at a
//      time per warp]: each warp holds its 16 rows' whole score rows in the
//      wgmma accumulator fragments (KT key tiles of 16; KT = 8, 13, 16 for
//      L <= 128, 208, 256). Row max and sum take four independent chains
//      and two quad shuffles; exp(scale * (s - m)) is one FFMA and one ex2;
//      the normalised probabilities are packed into PV's bf16 A fragments
//      in place. Above 256 keys a warp makes three passes over 256-key
//      chunks (max, sum, then p and PV), recomputing the same scores bit for
//      bit, so the rounding points hold up to kMaxL.
//   4. Operands [32-bit shared loads]: Q fragments by ldmatrix.x4 from rows
//      padded to 144 bytes; K and V are read by wgmma itself, once per
//      warpgroup instead of once per warp.
//   5. Products: wgmma m64n64k16 (m64n16k16 for the last tiles), bf16 in,
//      f32 sums, A (Q or p) from registers, asynchronous. K and V are staged
//      with zeros up to whole multiples of the keys a warp holds, so no
//      product sits under a runtime branch (ptxas would serialize it). f32:
//      the same fragment layout of scores, filled and consumed by FFMA from
//      shared memory (float4 reads from 272-byte rows), so the softmax is
//      one code.
// Measured on the H100 (PERF.md): still behind scaled_dot_product_attention
// by ~1.2x at L=197 and ~1.5x at 128 and 256; ahead of it at B=1. What
// holds it there (experiments/torch_attention_phase_trace.py): a block
// waits for K for a quarter (L=197) to two fifths (L=128) of its cycles;
// within a round the softmax takes longer than both products, because the
// exact softmax needs the whole score row in registers (~104-128 a
// thread), so an SM holds 2 blocks (8 warps) at L >= 129 and little else
// runs during a warp's ex2 and reductions; 13 slices in rounds of 4 leave
// three warps' rows empty in the last round at L=197. Left for later: a
// persistent block that loads head n+1 while it computes head n, and two
// warpgroups per block that overlap one's softmax with the other's
// products.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;       // head width
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxL = 416;
constexpr int kChunkKT = 16;  // key tiles of 16 a warp holds at most: 256 keys
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegMax = -3.402823466e38f;

// Shared-memory row stride (elements) of a staged 64-channel row: bf16 Q
// slices, 144 B (8 ldmatrix rows hit 8 distinct 4-bank groups); f32 K and
// V, 272 B (8 float4 reads of 8 rows likewise).
template <typename T>
__host__ __device__ constexpr int row_stride() { return sizeof(T) == 2 ? kDh + 8 : kDh + 4; }

// Blocks per SM the register budget is set for (__launch_bounds__): 3 up to
// 128 keys a warp; 2 above, where a lower budget spills (measured slower).
template <int KT>
__host__ __device__ constexpr int min_blocks() { return KT <= 8 ? 3 : 2; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // batch / row strides, elements
  int L, H, splits, per;  // per: query slices of 16 per block
  float scale_log2;  // scale * log2 e (scale > 0)
};

// Element offset of channels 8c..8c+7 (bf16) or 4c..4c+3 (f32) of staged
// key row j. bf16: K and V are kept as wgmma core matrices (core_at,
// hopper.cuh). f32: plain rows of kDh + 4 floats.
template <typename T>
__host__ __device__ constexpr int kv_at(int j, int c) {
  return sizeof(T) == 2 ? core_at(j, 8 * c, kDh / 8) : j * row_stride<float>() + c * 4;
}

// Keys staged in shared memory: bf16 stages zeros up to a whole number of
// the KT*16 keys a warp holds, so that every product is unconditional (a
// wgmma under a runtime branch is serialized); f32 stages L rounded to 16.
template <typename T, int KT>
__host__ __device__ int staged_keys(int L) {
  return sizeof(T) == 2 ? (L + 16 * KT - 1) / (16 * KT) * (16 * KT) : (L + 15) / 16 * 16;
}

template <typename T, int KT>
size_t smem_bytes(int L) {
  const int Lk = staged_keys<T, KT>(L);
  return sizeof(T) == 2 ? sizeof(bf16) * (2 * Lk * kDh + kWarps * 16 * row_stride<bf16>())
                        : sizeof(float) * 2 * Lk * row_stride<float>();
}

// d (m64n64, 32 f32 a thread) += a (this warp's 16 rows x 16, registers) * B (16 x 64
// in shared memory, K-major, described by `desc`).
__device__ __forceinline__ void wgmma_k64(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (m64n16, 8 f32 a thread) += a (this warp's 16 rows x 16, registers) * B (16 x 16
// in shared memory, K-major, described by `desc`).
__device__ __forceinline__ void wgmma_k16(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (m64n64, 32 f32 a thread) += a (this warp's 16 rows x 16, registers) * B (16 x 64
// in shared memory, MN-major, described by `desc`).
__device__ __forceinline__ void wgmma_v64(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Byte strides of the core-matrix layout (kv_at<bf16>): along K of QK^T
// (channels) 128 B, along its N (keys) 1024 B; for PV, K (keys) 1024 B and
// N (channels) 128 B.
constexpr uint32_t kQkLbo = 128, kQkSbo = 1024, kPvLbo = 1024, kPvSbo = 128;

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// kNegMax for keys at or past L (only the tiles that reach there pay for
// the test).
template <int KT>
__device__ __forceinline__ void mask(float (&s)[2 * KT][4], int c0, int L) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (c0 + nt * 8 + 8 > L) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c0 + nt * 8 + 2 * tg + e >= L) s[nt][e] = s[nt][2 + e] = kNegMax;
      }
    }
  }
}

// Unscaled scores (f32 sums of products) of a warp's 16 query rows against
// keys c0 .. c0 + 16*KT - 1, in the accumulator layout of mma and wgmma:
// s[nt][0..1] row g, s[nt][2..3] row g + 8, keys c0 + nt*8 + 2*tg + {0, 1};
// kNegMax for keys past L. bf16: the warpgroup's products of its Q
// fragments qa with the staged K (zeros past L) by wgmma.
template <int KT>
__device__ __forceinline__ void scores(float (&s)[2 * KT][4], const uint32_t (&qa)[4][4],
                                       const bf16* s_k, int c0, int, int L) {
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  wgmma_fence();
  // Groups of four 16-key tiles take one m64n64 product per k-step, the
  // tiles left over one m64n16 each.
#pragma unroll
  for (int t = 0; t < KT; t += 4) {
    if (t + 4 <= KT) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_k64(&s[2 * t][0], qa[ks],
                  wgmma_desc(s_k + kv_at<bf16>(c0 + t * 16, 2 * ks), kQkLbo, kQkSbo));
    } else {
#pragma unroll
      for (int u = t; u < KT; ++u)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_k16(&s[2 * u][0], qa[ks],
                    wgmma_desc(s_k + kv_at<bf16>(c0 + u * 16, 2 * ks), kQkLbo, kQkSbo));
    }
  }
  wgmma_commit_and_wait();
  mask<KT>(s, c0, L);
}

// f32: the same layout by FFMA. q rows ra and rb (zero past L) are read from
// global memory 16 channels at a time; each score is one sequential f32 sum
// over d = 0..63.
template <int KT>
__device__ __forceinline__ void scores(float (&s)[2 * KT][4], const float* qra, const float* qrb,
                                       const float* s_k, int c0, int Lp, int L) {
  constexpr int kRow = row_stride<float>();
  const int lane = threadIdx.x & 31, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int dc = 0; dc < kDh; dc += 16) {
    float4 qa[4], qb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qra ? ld4(qra + dc + 4 * i) : zero;
      qb[i] = qrb ? ld4(qrb + dc + 4 * i) : zero;
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (c0 + nt * 8 < Lp) {
        const float* k0 = s_k + (c0 + nt * 8 + 2 * tg) * kRow + dc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(k0 + 4 * i), y = ld4(k0 + kRow + 4 * i);
          s[nt][0] = dot4(s[nt][0], qa[i], x);
          s[nt][1] = dot4(s[nt][1], qa[i], y);
          s[nt][2] = dot4(s[nt][2], qb[i], x);
          s[nt][3] = dot4(s[nt][3], qb[i], y);
        }
      }
    }
  }
  mask<KT>(s, c0, L);
}

// The scores of one chunk for either operand type.
template <int KT>
__device__ __forceinline__ void fill(float (&s)[2 * KT][4], const uint32_t (&qa)[4][4],
                                     const bf16* s_k, const bf16*, int, int, long long, int c0,
                                     int Lp, int L) {
  scores<KT>(s, qa, s_k, c0, Lp, L);
}

template <int KT>
__device__ __forceinline__ void fill(float (&s)[2 * KT][4], const uint32_t (&)[4][4],
                                     const float* s_k, const float* q, int ra, int rb,
                                     long long q_rs, int c0, int Lp, int L) {
  scores<KT>(s, ra < L ? q + (size_t)ra * q_rs : nullptr, rb < L ? q + (size_t)rb * q_rs : nullptr,
             s_k, c0, Lp, L);
}

// Row maxima of the unscaled scores (scale > 0, so they are the maxima of
// the scaled ones), four independent chains per row.
template <int KT>
__device__ __forceinline__ void row_max(const float (&s)[2 * KT][4], float& ma, float& mb) {
  float pa[4] = {ma, kNegMax, kNegMax, kNegMax}, pb[4] = {mb, kNegMax, kNegMax, kNegMax};
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    pa[nt & 3] = fmaxf(pa[nt & 3], fmaxf(s[nt][0], s[nt][1]));
    pb[nt & 3] = fmaxf(pb[nt & 3], fmaxf(s[nt][2], s[nt][3]));
  }
  ma = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3]));
  mb = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3]));
}

// s <- exp(scale * (s - m)) in place, as ex2(s * c - m * c) with c = scale *
// log2 e in one FFMA (a masked key gives ex2 of about -1e37, 0); adds the
// row sums, four independent chains per row.
template <int KT>
__device__ __forceinline__ void exp_sum(float (&s)[2 * KT][4], float ma, float mb, float c,
                                        float& suma, float& sumb) {
  const float mca = -ma * c, mcb = -mb * c;
  float pa[4] = {suma, 0.f, 0.f, 0.f}, pb[4] = {sumb, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = exp2f(fmaf(s[nt][e], c, mca));
      s[nt][2 + e] = exp2f(fmaf(s[nt][2 + e], c, mcb));
      pa[nt & 3] += s[nt][e];
      pb[nt & 3] += s[nt][2 + e];
    }
  suma = (pa[0] + pa[1]) + (pa[2] + pa[3]);
  sumb = (pb[0] + pb[1]) + (pb[2] + pb[3]);
}

// o += p v for keys c0 .. c0 + 16*KT - 1: bf16 p (normalised, packed to A
// fragments) times the staged V (zeros past L), read transposed, by wgmma.
// o[nt]: channels nt*8 + 2*tg + {0, 1} of rows g (o[nt][0..1]) and g + 8
// (o[nt][2..3]).
template <int KT>
__device__ __forceinline__ void pv(float (&o)[8][4], const float (&s)[2 * KT][4], float ia,
                                   float ib, const bf16* s_v, int c0, int) {
  uint32_t a[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0] * ia, s[2 * kk][1] * ia);
    a[kk][1] = pack_bf16(s[2 * kk][2] * ib, s[2 * kk][3] * ib);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0] * ia, s[2 * kk + 1][1] * ia);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2] * ib, s[2 * kk + 1][3] * ib);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    wgmma_v64(&o[0][0], a[kk], wgmma_desc(s_v + kv_at<bf16>(c0 + kk * 16, 0), kPvLbo, kPvSbo));
  wgmma_commit_and_wait();
}

// f32: o[0][.] row g, o[1][.] row g + 8, channels i*16 + 4*tg + {0..3} at
// o[.][4i..4i+3]. Each lane takes the quad's p values by shuffle, so every
// output is one sequential f32 sum over the keys.
template <int KT>
__device__ __forceinline__ void pv(float (&o)[2][16], const float (&s)[2 * KT][4], float ia,
                                   float ib, const float* s_v, int c0, int Lp) {
  constexpr int kRow = row_stride<float>();
  const int lane = threadIdx.x & 31, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (c0 + nt * 8 < Lp) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const int from = (lane & ~3) | src;
        const float pa[2] = {__shfl_sync(0xffffffffu, s[nt][0], from) * ia,
                             __shfl_sync(0xffffffffu, s[nt][1], from) * ia};
        const float pb[2] = {__shfl_sync(0xffffffffu, s[nt][2], from) * ib,
                             __shfl_sync(0xffffffffu, s[nt][3], from) * ib};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* vr = s_v + (c0 + nt * 8 + 2 * src + e) * kRow + 4 * tg;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 x = ld4(vr + 16 * i);
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              o[0][4 * i + c] = fmaf(pa[e], xs[c], o[0][4 * i + c]);
              o[1][4 * i + c] = fmaf(pb[e], xs[c], o[1][4 * i + c]);
            }
          }
        }
      }
    }
  }
}

template <typename T, int KT, bool kChunked>
__global__ void __launch_bounds__(kThreads, min_blocks<KT>()) attention_kernel(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kQRow = row_stride<bf16>();
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = kDh / kVec;   // 16-byte copies per 64-channel row
  constexpr int kKeys = 16 * KT;        // keys a warp holds in registers
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = p.L, Lp = (L + 15) / 16 * 16, Lk = staged_keys<T, KT>(L);
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + kv_at<T>(Lk, 0);
  bf16* s_q = reinterpret_cast<bf16*>(s_v + kv_at<T>(Lk, 0)) + (threadIdx.x >> 5) * 16 * kQRow;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const long long bh = blockIdx.x / p.splits;
  const int split = blockIdx.x - bh * p.splits;
  const long long b = bh / p.H;
  const int col = (int)(bh - b * p.H) * kDh;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_bs + col;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_bs + col;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_bs + col;
  T* ob = static_cast<T*>(p.o) + b * p.o_bs + col;
  const int sl0 = split * p.per;
  const int sl1 = min(sl0 + p.per, Lp / 16);
  const int rounds = (sl1 - sl0 + kWarps - 1) / kWarps;

  // The warp's 16-row Q slice `sl` into its buffer (zeros past L), 4 copies a lane (bf16).
  auto stage_q = [&](int sl) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = lane + 32 * u, r = sl * 16 + (idx >> 3), c = (idx & 7) * 8;
      cp_async16(s_q + (idx >> 3) * kQRow + c,
                 reinterpret_cast<const bf16*>(qb) + (size_t)(r < L ? r : 0) * p.q_rs + c, r < L);
    }
  };

  // Group 0: K (and each warp's first Q slice); group 1: V. Rows past L are zeros.
  for (int idx = tid; idx < Lk * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    cp_async16(s_k + kv_at<T>(j, c), kb + (size_t)(j < L ? j : 0) * p.k_rs + c * kVec, j < L);
  }
  if constexpr (kBf16) {
    if (sl0 + warp < sl1) stage_q(sl0 + warp);
  }
  cp_async_commit();
  for (int idx = tid; idx < Lk * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    cp_async16(s_v + kv_at<T>(j, c), vb + (size_t)(j < L ? j : 0) * p.v_rs + c * kVec, j < L);
  }
  cp_async_commit();
  cp_async_wait<1>();
  if constexpr (kBf16) fence_proxy_async();
  __syncthreads();

  // Above kKeys keys (the chunked instantiation) the scores are recomputed
  // chunk by chunk in each pass; otherwise there is one chunk, known at
  // compile time.
  constexpr bool single = !kChunked;
  const int c_end = single ? 1 : Lp;
  // Every warp takes part in every round (bf16 products are collective over
  // the warpgroup); a warp without a slice computes on zero or stale rows
  // and stores nothing.
  for (int r = 0; r < rounds; ++r) {
    const int sl = sl0 + r * kWarps + warp;
    const bool active = sl < sl1;
    const int ra = sl * 16 + g, rb = ra + 8;
    float s[2 * KT][4];
    float ma = kNegMax, mb = kNegMax, suma = 0.f, sumb = 0.f;
    uint32_t qa[4][4] = {};
    // bf16: Q fragments of this slice, then the copy of the warp's next slice.
    if constexpr (kBf16) {
      if (r > 0) {
        cp_async_wait<0>();
        __syncwarp();
      }
      if (active) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldmatrix_x4(qa[ks], s_q + (lane & 15) * kQRow + ks * 16 + (lane >> 4) * 8);
      }
      __syncwarp();
      if (sl + kWarps < sl1) stage_q(sl + kWarps);
      cp_async_commit();
    }
    // Exact softmax: the whole row's max, then its sum.
    if (single) fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, 0, Lp, L);
    for (int c0 = 0; c0 < c_end; c0 += kKeys) {
      if (!single) fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, c0, Lp, L);
      row_max<KT>(s, ma, mb);
    }
    ma = quad_max(ma);
    mb = quad_max(mb);
    for (int c0 = 0; c0 < c_end; c0 += kKeys) {
      if (!single) fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, c0, Lp, L);
      exp_sum<KT>(s, ma, mb, p.scale_log2, suma, sumb);
    }
    suma = quad_sum(suma);
    sumb = quad_sum(sumb);
    if (r == 0) {  // V has landed for every warp
      if constexpr (kBf16) {
        cp_async_wait<1>();
        fence_proxy_async();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float ia = 1.f / suma, ib = 1.f / sumb;
    if constexpr (kBf16) {
      float o[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
      for (int c0 = 0; c0 < c_end; c0 += kKeys) {
        if (!single) {
          fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, c0, Lp, L);
          float unused_a = 0.f, unused_b = 0.f;
          exp_sum<KT>(s, ma, mb, p.scale_log2, unused_a, unused_b);
        }
        pv<KT>(o, s, ia, ib, s_v, c0, Lp);
      }
      if (!active) continue;
      bf16* o16 = reinterpret_cast<bf16*>(ob) + 2 * tg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (ra < L)
          *reinterpret_cast<__nv_bfloat162*>(o16 + (size_t)ra * p.o_rs + nt * 8) =
              __floats2bfloat162_rn(o[nt][0], o[nt][1]);
        if (rb < L)
          *reinterpret_cast<__nv_bfloat162*>(o16 + (size_t)rb * p.o_rs + nt * 8) =
              __floats2bfloat162_rn(o[nt][2], o[nt][3]);
      }
    } else {
      float o[2][16];
#pragma unroll
      for (int i = 0; i < 16; ++i) o[0][i] = o[1][i] = 0.f;
      for (int c0 = 0; c0 < c_end; c0 += kKeys) {
        if (!single) {
          fill<KT>(s, qa, s_k, qb, ra, rb, p.q_rs, c0, Lp, L);
          float unused_a = 0.f, unused_b = 0.f;
          exp_sum<KT>(s, ma, mb, p.scale_log2, unused_a, unused_b);
        }
        pv<KT>(o, s, ia, ib, s_v, c0, Lp);
      }
      if (!active) continue;
      float* o32 = reinterpret_cast<float*>(ob) + 4 * tg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ra < L)
          *reinterpret_cast<float4*>(o32 + (size_t)ra * p.o_rs + 16 * i) =
              make_float4(o[0][4 * i], o[0][4 * i + 1], o[0][4 * i + 2], o[0][4 * i + 3]);
        if (rb < L)
          *reinterpret_cast<float4*>(o32 + (size_t)rb * p.o_rs + 16 * i) =
              make_float4(o[1][4 * i], o[1][4 * i + 1], o[1][4 * i + 2], o[1][4 * i + 3]);
      }
    }
  }
}

template <typename T, int KT, bool kChunked = false>
int launch_kt(const Params& p, long long BH, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, KT>(p.L);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, KT, kChunked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T, KT, kChunked><<<(unsigned)(BH * p.splits), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(Params p, long long BH, cudaStream_t stream) {
  // Query slices of 16 over blocks: one block per head, or, when the heads
  // are too few to fill the card twice over, up to one block per 4 slices.
  const int slices = (p.L + 15) / 16;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long splits = 1;
  if (BH < 2LL * sms) {
    splits = (2LL * sms + BH - 1) / BH;
    const long long most = (slices + kWarps - 1) / kWarps;
    if (splits > most) splits = most;
  }
  p.per = (int)((slices + splits - 1) / splits);
  p.splits = (slices + p.per - 1) / p.per;  // no block without a slice
  if (BH * p.splits > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int Lp = slices * 16;
  if (Lp <= 128) return launch_kt<T, 8>(p, BH, stream);
  if (Lp <= 208) return launch_kt<T, 13>(p, BH, stream);
  if (Lp <= 16 * kChunkKT) return launch_kt<T, kChunkKT>(p, BH, stream);
  return launch_kt<T, kChunkKT, true>(p, BH, stream);
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

int run(const void* q, const void* k, const void* v, void* o, long long q_bs, long long q_rs,
        long long k_bs, long long k_rs, long long v_bs, long long v_rs, long long o_bs,
        long long o_rs, long long B, int L, int H, float scale, int f32, void* stream) {
  if (B < 1 || L < 1 || L > kMaxL || H < 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if ((q_bs | q_rs | k_bs | k_rs | v_bs | v_rs) & 7) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs; p.v_bs = v_bs; p.v_rs = v_rs;
  p.o_bs = o_bs; p.o_rs = o_rs;
  p.L = L;
  p.H = H;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(p, B * H, s) : launch<bf16>(p, B * H, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). q, k, v: (B, L, D = 64 * H),
// bf16 (f32 = 0) or f32 (f32 = 1), unit channel stride and the given batch /
// row strides (elements, multiples of 8, 16-byte aligned pointers); o: (B,
// L, D) of the same type, contiguous, allocated by the caller. L <= 416.
int parseq_attention_nosplit(const void* q, const void* k, const void* v, void* o,
                             long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                             long long v_bs, long long v_rs, int B, int L, int D, int H,
                             float scale, int f32, void* stream) {
  if (D != H * kDh) return (int)cudaErrorInvalidValue;
  return run(q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, (long long)L * D, D, B, L, H, scale,
             f32, stream);
}

// Returns a cudaError_t code (0 = launched). Head-split attention (kernel
// B3): q, k, v are (BH, L, 64), bf16 (f32 = 0) or f32 (f32 = 1), unit
// channel stride and the given batch-head / row strides (elements,
// multiples of 8, 16-byte aligned pointers); o: (BH, L, 64) of the same
// type, contiguous, allocated by the caller. One launch for any BH.
int parseq_attention_split(const void* q, const void* k, const void* v, void* o,
                           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                           long long v_bs, long long v_rs, long long BH, int L, float scale,
                           int f32, void* stream) {
  return run(q, k, v, o, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, (long long)L * kDh, kDh, BH, L, 1,
             scale, f32, stream);
}

int parseq_attention_max_len() { return kMaxL; }

const char* parseq_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
