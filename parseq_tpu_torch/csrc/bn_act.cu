// Eval-mode batch norm, an optional shortcut and ReLU over a convolution's
// output, in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves ops/cnn.py:batchnorm, the
// residual add and the ReLU to XLA, which fuses them into the convolution's
// epilogue. In eager PyTorch they are about nine passes a site: a cast to
// f32, the subtraction of the mean, the multiplication, the shift, a cast
// back, the residual add and the ReLU. On a tensor y of (B, C, H, W), one
// launch computes, with those passes' rounding points,
//   o   = T(((f32(y) - mean_c) * inv_c) + shift_c)     each step rounded to f32
//   o   = T(f32(o) + f32(r))                            identity shortcut
//   o   = T(f32(o) + f32(T(bn_s(r))))                   or a normalised one
//   out = isnan(o) ? o : T(fmaxf(o, 0))                 ReLU, as clamp_min
// where T is bf16 or f32 (T(x) rounds to nearest even; for f32 nothing
// rounds). The subtraction, product and sum are __fsub_rn / __fmul_rn /
// __fadd_rn, so nothing contracts into an FMA and the output is bit for bit
// the separate passes'. inv_c = rsqrt(var_c + eps) * weight_c is formed
// here, where a channel's vectors are loaded, as torch forms it on the card:
// __fadd_rn, then rsqrtf (the function torch's CUDA rsqrt calls for float),
// then __fmul_rn. The caller passes the batch norm's own float32 tensors,
// so no per-channel vector is made or kept between calls.
//
// What bounds it on this card: memory. Each element reads 2 bytes (bf16)
// and writes 2, 4 more where a shortcut is read; the per-channel vectors
// are a few KB. At ABINet's largest map, (512, 32, 32, 128), one pass moves
// 268 MB: 80 us at 3.35 TB/s.
//
// What the design does about it:
//   * 16-byte loads and stores: 8 bf16 (4 f32) a vector, where a vector
//     holds one channel (NCHW, H*W a multiple of the vector) or channels
//     c..c+7 (channels-last, C a multiple of it), and every pointer is 16-byte
//     aligned; else one element a thread, the channel worked out for each.
//   * Channels-last, the layout cuDNN returns for the port's NHWC images:
//     the grid's stride is a multiple of C, so a thread's channels never
//     change and it forms their affine (mean, inv, shift) in registers once.
//   * A thread loads kUnroll vectors (and their shortcuts) before it
//     computes, so each SM keeps enough bytes in flight; the grid is one
//     wave of resident blocks that stride over the tensor.
//   * The layout, shortcut, ReLU and dtype are template parameters: no branch
//     in the loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum Shortcut { kNone = 0, kIdentity = 1, kNormed = 2 };

struct Aff {
  float mean, inv, shift;
};

// A batch norm's running statistics and affine parameters: C float32 each.
struct Stats {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ Aff load_aff(const Stats& s, int c) {
  const float inv = __fmul_rn(rsqrtf(__fadd_rn(__ldg(s.var + c), s.eps)), __ldg(s.weight + c));
  return {__ldg(s.mean + c), inv, __ldg(s.bias + c)};
}

template <typename T>
__device__ __forceinline__ T batchnorm(T y, Aff a) {
  return round_to<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_f(y), a.mean), a.inv), a.shift));
}

template <typename T, int kShortcut, bool kRelu>
__device__ __forceinline__ T one(T y, T r, Aff a, Aff ar) {
  T o = batchnorm(y, a);
  if (kShortcut == kIdentity) o = round_to<T>(__fadd_rn(to_f(o), to_f(r)));
  if (kShortcut == kNormed) o = round_to<T>(__fadd_rn(to_f(o), to_f(batchnorm(r, ar))));
  if (kRelu) {
    const float f = to_f(o);
    if (!isnan(f)) o = round_to<T>(fmaxf(f, 0.0f));
  }
  return o;
}

// nvec vectors of V = 16 / sizeof(T) elements. kNHWC: channel = index % C
// (inner == 1), C a multiple of V, and the grid's stride times V a multiple
// of C; else channel = (index / inner) % C with inner a multiple of V.
template <typename T, bool kNHWC, int kShortcut, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_act_vec(const T* __restrict__ y, const T* __restrict__ r, const Stats st, const Stats st_r,
               T* __restrict__ out, int nvec, int C, int inner) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kA = kNHWC ? V : 1;
  const int stride = gridDim.x * kThreads;
  int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= nvec) return;
  Aff a[kA], ar[kA];
  if (kNHWC) {
    const int c0 = (v * V) % C;
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      a[j] = load_aff(st, c0 + j);
      if (kShortcut == kNormed) ar[j] = load_aff(st_r, c0 + j);
    }
  }
  for (; v < nvec; v += kUnroll * stride) {
    uint4 yv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = v + u * stride;
      if (w < nvec) {
        yv[u] = reinterpret_cast<const uint4*>(y)[w];
        if (kShortcut != kNone) rv[u] = reinterpret_cast<const uint4*>(r)[w];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = v + u * stride;
      if (w >= nvec) break;
      if (!kNHWC) {
        const int c = (w * V / inner) % C;
        a[0] = load_aff(st, c);
        if (kShortcut == kNormed) ar[0] = load_aff(st_r, c);
      }
      const T* ye = reinterpret_cast<const T*>(&yv[u]);
      const T* re = reinterpret_cast<const T*>(&rv[u]);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < V; ++j)
        oe[j] = one<T, kShortcut, kRelu>(ye[j], kShortcut != kNone ? re[j] : T(), a[kNHWC ? j : 0],
                                          ar[kNHWC ? j : 0]);
      reinterpret_cast<uint4*>(out)[w] = ov;
    }
  }
}

// one element a step, any C and inner
template <typename T, int kShortcut, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_act_scalar(const T* __restrict__ y, const T* __restrict__ r, const Stats st,
                  const Stats st_r, T* __restrict__ out, int n, int C, int inner) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int c = (int)((i / inner) % C);
    Aff ar{};
    if (kShortcut == kNormed) ar = load_aff(st_r, c);
    out[i] = one<T, kShortcut, kRelu>(y[i], kShortcut != kNone ? r[i] : T(), load_aff(st, c), ar);
  }
}

struct Args {
  const void* y;
  const void* r;
  Stats st, st_r;
  void* out;
  int n, C, inner;
};

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// The most blocks of kKernel all SMs of the current device hold at once,
// asked once a kernel and device.
constexpr int kMaxDevices = 64;
template <auto kKernel>
cudaError_t one_wave(int* blocks) {
  static int known[kMaxDevices] = {};
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && known[dev]) {
    *blocks = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev] = *blocks;
  return cudaSuccess;
}

template <typename T, int kShortcut, bool kRelu>
cudaError_t run(const Args& a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* y = static_cast<const T*>(a.y);
  const T* r = static_cast<const T*>(a.r);
  T* out = static_cast<T*>(a.out);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.y) | reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.r)) & 15) == 0;
  const bool nhwc = a.inner == 1;
  int wave;
  cudaError_t e;
  if (aligned && (nhwc ? a.C % V == 0 : a.inner % V == 0)) {
    const int nvec = a.n / V;
    const int want = (nvec + kThreads - 1) / kThreads;
    if (nhwc) {
      constexpr auto kernel = bn_act_vec<T, true, kShortcut, kRelu>;
      if ((e = one_wave<kernel>(&wave)) != cudaSuccess) return e;
      // a grid whose stride (grid * kThreads * V elements) is a multiple of C
      const int m = a.C / gcd(a.C, kThreads * V);
      int grid = want < wave ? want : wave;
      grid = grid / m * m > m ? grid / m * m : m;
      kernel<<<grid, kThreads, 0, stream>>>(y, r, a.st, a.st_r, out, nvec, a.C, a.inner);
    } else {
      constexpr auto kernel = bn_act_vec<T, false, kShortcut, kRelu>;
      if ((e = one_wave<kernel>(&wave)) != cudaSuccess) return e;
      kernel<<<want < wave ? want : wave, kThreads, 0, stream>>>(y, r, a.st, a.st_r, out, nvec,
                                                                 a.C, a.inner);
    }
  } else {
    constexpr auto kernel = bn_act_scalar<T, kShortcut, kRelu>;
    if ((e = one_wave<kernel>(&wave)) != cudaSuccess) return e;
    const int want = (a.n + kThreads - 1) / kThreads;
    kernel<<<want < wave ? want : wave, kThreads, 0, stream>>>(y, r, a.st, a.st_r, out, a.n, a.C,
                                                               a.inner);
  }
  return cudaGetLastError();
}

template <typename T, int kShortcut>
cudaError_t run_relu(const Args& a, int relu, cudaStream_t stream) {
  return relu ? run<T, kShortcut, true>(a, stream) : run<T, kShortcut, false>(a, stream);
}

template <typename T>
cudaError_t run_shortcut(const Args& a, int shortcut, int relu, cudaStream_t stream) {
  switch (shortcut) {
    case kNone: return run_relu<T, kNone>(a, relu, stream);
    case kIdentity: return run_relu<T, kIdentity>(a, relu, stream);
    default: return run_relu<T, kNormed>(a, relu, stream);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = launched). y, out and (shortcut 1 or 2) r:
// n elements of one layout, bf16 (dtype 0) or f32 (dtype 1); the channel of
// element i is (i / inner) % C (inner = H * W for NCHW, 1 for channels-last).
// mean, var, weight, bias: the batch norm's C float32 each, and its eps
// (and, shortcut 2, the shortcut's batch norm: *_r). shortcut 0: none; 1: r
// is added; 2: r is normalised by the second batch norm, rounded, then
// added. n < 2^31.
int parseq_bn_act(const void* y, const void* r, void* out, const float* mean, const float* var,
                  const float* weight, const float* bias, float eps, const float* mean_r,
                  const float* var_r, const float* weight_r, const float* bias_r, float eps_r,
                  int shortcut, int n, int C, int inner, int dtype, int relu, void* stream) {
  if (n < 1 || C < 1 || inner < 1 || shortcut < kNone || shortcut > kNormed ||
      (dtype != 0 && dtype != 1) || !y || !out || !mean || !var || !weight || !bias ||
      (shortcut != kNone && !r) ||
      (shortcut == kNormed && (!mean_r || !var_r || !weight_r || !bias_r)) ||
      n % ((long long)C * inner) != 0)
    return cudaErrorInvalidValue;
  const Args a{y, r, {mean, var, weight, bias, eps}, {mean_r, var_r, weight_r, bias_r, eps_r},
               out, n, C, inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_shortcut<__nv_bfloat16>(a, shortcut, relu, s)
                    : run_shortcut<float>(a, shortcut, relu, s);
}

const char* parseq_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
