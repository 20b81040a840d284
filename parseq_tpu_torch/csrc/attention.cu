// Unmasked multi-head self-attention on the unsplit (B, L, D) layout, for
// Hopper (sm_90a): kernel B2 of the port; and, through a second entry, the
// same computation on the head-split (BH, L, dh) layout: kernel B3.
//
// Replaces the Pallas TPU kernel
// parseq_tpu/ops/attention.py:_pallas_attention_nosplit (wrapper
// fused_attention_nosplit), which the JAX package runs for every encoder
// self-attention with L >= KERNEL_MIN_LEN = 192: ViTSTR (L=197, 6 heads,
// D=384), PARSeq patch16-224 (L=196, 6 heads, D=384) and ABINet's vision
// transformer (L=256, 8 heads, D=512). For batch row b, head h and query i:
//   s_j = (sum_d q[b,i,h*64+d] * k[b,j,h*64+d]) * scale   bf16 x bf16, f32 sums
//   p_j = exp(s_j - max s) / sum exp(...)                  f32, normalised
//                                                          before the bf16 cast
//   o   = sum_j bf16(p_j) * v[b,j,h*64:...]                f32 sums, stored bf16
//
// What bounds it on this card: it must move q, k, v in and o out,
// 3*B*L*D*2 + B*L*D*2 bytes, ~155 MB per layer for ViTSTR at B=256, ~46 us
// at 3.35 TB/s; its 4*B*h*L^2*64 FLOP (15 GFLOP per ViTSTR layer at
// B=256) are ~16 us at the bf16 tensor-core peak. The plain PyTorch version
// also writes and re-reads the (B, h, L, L) f32 scores and probabilities,
// ~238 MB per pass per layer at that shape.
//
// What the design does about it: scores never leave shared memory.
//   * Grid (query tiles of 64, heads, batch rows); 4 warps, 16 query rows
//     each. A block stages its head's K (row-major) and V (transposed) in
//     shared memory, zero-padded to a multiple of 16 keys.
//   * Each query row keeps its WHOLE f32 score row in shared memory, so p is
//     normalised with the exact row max and sum before it is rounded to bf16,
//     as the TPU kernel does (no online softmax, which would round elsewhere).
//     The bf16 probabilities are written in place over their own f32 row,
//     and the Q tile is staged inside the same rows before the scores: a
//     warp only touches its own 16 rows, so no block barrier is needed
//     between the phases and shared memory is K + V + scores (112 KB at
//     L=197: two blocks per SM; 137 KB at L=256: one).
//   * Both products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     fragments read straight from shared memory; every row stride is 8
//     (mod 16) bf16 elements, so those 32-bit fragment loads are free of
//     bank conflicts.
//   * q, k and v are read with their own batch and row strides, so the
//     wrapper passes views of the packed (B, L, 3D) qkv projection with no
//     copies. o is (B, L, D) contiguous.
//   * Ragged L (197, 196) and the last query tile are masked.
// Not done yet: TMA/cp.async staging, wgmma, sharing K/V across query tiles.
//
// Kernel B3 replaces parseq_tpu/ops/attention.py:_pallas_attention (wrapper
// fused_attention): q, k, v are (BH, L, dh) with dh = 64, one head per batch
// row. Its entry, parseq_attention_split, runs the kernel above with one
// 64-column head per row (H = 1, D = 64), cutting BH into launches of at
// most 65535 rows (grid z). The TPU kernel's heads_per_block grouping is a
// VMEM blocking choice and is not carried over. Its bound at (1536, 128,
// 64) bf16: q, k, v in and o out, 100.7 MB, ~30 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDh = 64;                 // head width
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = kWarps * 16;        // query rows per block, 16 per warp
constexpr int kMaxL = 416;              // softmax keeps a row in registers; smem bound
constexpr int kPerLane = kMaxL / 32;
constexpr int kRowPad = 8;              // bf16 pad of a K / V^T row

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;                               // (B, L, D) contiguous
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // batch / row strides, elements
  int B, L, D, H;
  float scale;
};

struct Layout {
  int Lp;            // keys padded to a multiple of 16
  int KS, VS, SS;    // row strides: K (bf16), V^T (bf16), scores (f32 words)
  size_t k, vt, s, bytes;
};

__host__ __device__ inline Layout make_layout(int L) {
  Layout t;
  t.Lp = (L + 15) / 16 * 16;
  t.KS = kDh + kRowPad;   // 72
  t.VS = t.Lp + kRowPad;  // Lp + 8
  // == 4 (mod 8) words: conflict-free as f32 or bf16 rows; >= 32 words so a
  // 64-channel Q row fits in its score row.
  t.SS = (t.Lp > 32 ? t.Lp : 32) + 4;
  size_t off = 0;
  t.k = off;  off += sizeof(bf16) * t.Lp * t.KS;
  t.vt = off; off += sizeof(bf16) * kDh * t.VS;
  t.s = off;  off += sizeof(float) * kQT * t.SS;
  t.bytes = off;
  return t;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout t = make_layout(p.L);
  bf16* s_k = reinterpret_cast<bf16*>(smem + t.k);
  unsigned short* s_vt = reinterpret_cast<unsigned short*>(smem + t.vt);
  float* s_s = reinterpret_cast<float*>(smem + t.s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group / thread in group
  const int L = p.L;
  const int q0 = blockIdx.x * kQT, col = blockIdx.y * kDh, b = blockIdx.z;
  const bf16* qb = p.q + (size_t)b * p.q_bs + col;
  const bf16* kb = p.k + (size_t)b * p.k_bs + col;
  const bf16* vb = p.v + (size_t)b * p.v_bs + col;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // ---- stage K and V^T (zero rows past L) and the Q tile. Q row r goes
  // into the start of score row r (2*SS bf16 per row), which only the warp
  // owning row r reads and later overwrites.
  // Chunk idx -> key j = idx % Lp, channels c*8..c*8+7 with c = idx / Lp:
  // neighbouring lanes take neighbouring keys, so the 16-bit V^T stores of a
  // warp hit consecutive words (no bank conflicts).
  const int n_kv = t.Lp * 8;  // 16-byte chunks: 8 per 64-channel row
  for (int base = tid; base < n_kv; base += 4 * kThreads) {
    uint4 kv[4], vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads, c = idx / t.Lp, j = idx - c * t.Lp;
      kv[u] = zero;
      vv[u] = zero;
      if (idx < n_kv && j < L) {
        kv[u] = *reinterpret_cast<const uint4*>(kb + (size_t)j * p.k_rs + c * 8);
        vv[u] = *reinterpret_cast<const uint4*>(vb + (size_t)j * p.v_rs + c * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads, c = idx / t.Lp, j = idx - c * t.Lp;
      if (idx < n_kv) {
        *reinterpret_cast<uint4*>(s_k + j * t.KS + c * 8) = kv[u];
        const uint32_t w[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_vt[(c * 8 + 2 * e) * t.VS + j] = (unsigned short)(w[e] & 0xffffu);
          s_vt[(c * 8 + 2 * e + 1) * t.VS + j] = (unsigned short)(w[e] >> 16);
        }
      }
    }
  }
  {
    uint4 qv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // kQT * 8 == 4 * kThreads chunks
      const int idx = tid + u * kThreads, r = idx >> 3, c = idx & 7;
      qv[u] = zero;
      if (q0 + r < L) qv[u] = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * p.q_rs + c * 8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * kThreads, r = idx >> 3, c = idx & 7;
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(s_s + r * t.SS) + c * 8) = qv[u];
    }
  }
  __syncthreads();

  const int r0 = warp * 16;
  float* srow_g = s_s + (r0 + g) * t.SS;      // fragment rows g and g + 8 of this warp
  float* srow_g8 = srow_g + 8 * t.SS;
  const bf16* brow_g = reinterpret_cast<const bf16*>(srow_g);
  const bf16* brow_g8 = reinterpret_cast<const bf16*>(srow_g8);

  // ---- scores: S = Q K^T * scale for the warp's 16 rows, all Lp keys.
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int d = ks * 16 + 2 * tg;
    qa[ks][0] = ld32(brow_g + d);
    qa[ks][1] = ld32(brow_g8 + d);
    qa[ks][2] = ld32(brow_g + d + 8);
    qa[ks][3] = ld32(brow_g8 + d + 8);
  }
  __syncwarp();  // the Q tile is in registers before its rows turn into scores
  for (int n0 = 0; n0 < t.Lp; n0 += 8) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kr = s_k + (n0 + g) * t.KS + 2 * tg;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_bf16(c, qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    *reinterpret_cast<float2*>(srow_g + n0 + 2 * tg) = make_float2(c[0] * p.scale, c[1] * p.scale);
    *reinterpret_cast<float2*>(srow_g8 + n0 + 2 * tg) = make_float2(c[2] * p.scale, c[3] * p.scale);
  }
  __syncwarp();

  // ---- softmax, one row at a time across the warp; p (bf16) overwrites
  // the front half of its own f32 row once the row is in registers.
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = s_s + (r0 + rr) * t.SS;
    float x[kPerLane];
    float m = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < L ? srow[j] : -3.402823466e38f;
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < L ? expf(x[i] - m) : 0.f;
      sum += x[i];
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < t.Lp) prow[j] = __float2bfloat16_rn(x[i] * inv);  // 0 past L
    }
    __syncwarp();
  }

  // ---- O = P V: 16 rows x 64 channels per warp, 8 column tiles of 8.
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bf16* vt = reinterpret_cast<const bf16*>(s_vt);
  for (int kk = 0; kk < t.Lp; kk += 16) {
    const int j = kk + 2 * tg;
    const uint32_t a[4] = {ld32(brow_g + j), ld32(brow_g8 + j), ld32(brow_g + j + 8),
                           ld32(brow_g8 + j + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* vr = vt + (nt * 8 + g) * t.VS + j;
      mma_bf16(acc[nt], a, ld32(vr), ld32(vr + 8));
    }
  }

  const int ra = q0 + r0 + g, rb = ra + 8;
  bf16* ob = p.o + (size_t)b * L * p.D + col + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * p.D + nt * 8) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * p.D + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). q, k, v: bf16 with unit channel
// stride and the given batch / row strides (elements, multiples of 8, 16-byte
// aligned pointers); o: (B, L, D) bf16 contiguous, allocated by the caller.
int parseq_attention_nosplit(const void* q, const void* k, const void* v, void* o,
                             long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                             long long v_bs, long long v_rs, int B, int L, int D, int H,
                             float scale, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || L > kMaxL || H < 1 || H > 65535 || D != H * kDh)
    return (int)cudaErrorInvalidValue;
  if ((q_bs | q_rs | k_bs | k_rs | v_bs | v_rs) & 7) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs; p.v_bs = v_bs; p.v_rs = v_rs;
  p.B = B; p.L = L; p.D = D; p.H = H;
  p.scale = scale;
  const Layout t = make_layout(L);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kQT - 1) / kQT, H, B);
  attention_kernel<<<grid, kThreads, t.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t code (0 = launched). Head-split attention (kernel
// B3): q, k, v are (BH, L, 64) bf16 with unit channel stride and the given
// batch-head / row strides (elements, multiples of 8, 16-byte aligned
// pointers); o: (BH, L, 64) bf16 contiguous, allocated by the caller.
int parseq_attention_split(const void* q, const void* k, const void* v, void* o,
                           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                           long long v_bs, long long v_rs, long long BH, int L, float scale,
                           void* stream) {
  if (BH < 1) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < BH; b0 += 65535) {
    const int n = (int)(BH - b0 < 65535 ? BH - b0 : 65535);
    const int rc = parseq_attention_nosplit(
        static_cast<const bf16*>(q) + b0 * q_bs, static_cast<const bf16*>(k) + b0 * k_bs,
        static_cast<const bf16*>(v) + b0 * v_bs, static_cast<bf16*>(o) + b0 * L * kDh, q_bs, q_rs,
        k_bs, k_rs, v_bs, v_rs, n, L, kDh, 1, scale, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

int parseq_attention_max_len() { return kMaxL; }

const char* parseq_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
