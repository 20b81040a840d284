#!/usr/bin/env python
"""How fast one SM can stream kernel B1's decoder weights from L2, by copy kind.

    python experiments/torch_ar_decode_stream_probe.py

B1 (csrc/ar_decode.cu) streams ~3.9 MB of bf16 decoder weights through each
block on every one of its 26 steps: 162 slices of 192 weight rows x 64 k
(24 KB) of a step's seven products. This probe compiles a stand-alone CUDA
file (written to build/kernels/, not part of the port) whose kernels stream
a 5184 x 384 bf16 matrix (162 such slices, L2-resident after the first
pass) 26 times through shared memory, each slice behind one block barrier
as in B1's ring, and touch every byte landed (no tensor-core work), with:

  cp.async S=n      16-byte cp.async.cg a thread, n stages of 24 KB
  cp.async 12K S=8  the same with 96-row slices, 8 stages
  ld.v4             ld.global.nc.v4 into registers, 8 loads a thread in flight
  ld.v4 ILP 4       the same, 4 loads a thread in flight
  warp ring S=n     cp.async.cg, each warp its own 16 rows of every slice
                    through a ring of n 2 KB slabs of its own: no block
                    barrier, a __syncwarp a slice (.ca: cp.async.ca)
  bulk rows         cp.async.bulk of each 128-byte weight row (192 a slice),
                    completion on an mbarrier, 4 stages
  bulk tiled        the weight laid out slice after slice beforehand, one
                    24 KB cp.async.bulk a slice, 4 stages

It prints the bytes a cycle one SM takes, for one block alone and for 128
blocks at once (one an SM), and each kind's ms. Needs a CUDA card and nvcc;
the last line is one JSON object with the numbers.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))

import torch

from experiments.torch_encoder_kernel_bench import card_line
from parseq_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

ROWS, K, PASSES = 5184, 384, 26
SLICE_BYTES = 192 * 64 * 2

SOURCE = r'''
#include <cuda_bf16.h>
#include <stdint.h>
#include "hopper.cuh"

namespace {
constexpr int kThreads = 384, kK = 384, kRows = 5184, kSliceK = 64;

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(b)) : "memory");
}

// Slice g of the stream: rows (g / 6 % 27) * RS.., k (g % 6) * 64.. of W.
template <int S, int RS>
__global__ void __launch_bounds__(kThreads, 1) stream_cp_async(const __nv_bfloat16* W, int slices,
                                                                long long* cycles, uint32_t* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const long long t0 = clock64();
  const int tiles = kRows / RS;
  auto issue = [&](int g) {
    if (g < slices) {
      const int t = g / 6 % tiles, ks = g % 6;
      __nv_bfloat16* st = ring + (g % S) * RS * kSliceK;
      for (int q = threadIdx.x; q < RS * 8; q += kThreads) {
        const int r = q >> 3, c = q & 7;
        cp_async16(st + sw128_at(r, c), W + (size_t)(t * RS + r) * kK + ks * kSliceK + 8 * c, true);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  uint32_t acc = 0;
  for (int g = 0; g < slices; ++g) {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue(g + S - 1);
    const uint4* st = reinterpret_cast<const uint4*>(ring + (g % S) * RS * kSliceK);
    for (int q = threadIdx.x; q < RS * 8; q += kThreads) acc ^= st[q].x ^ st[q].w;
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

// Each warp streams its own 16 rows of every slice through a ring of S
// 16 x 64 slabs of its own: no block barrier, a __syncwarp a slice. CA:
// cp.async.ca (through L1) instead of .cg.
template <int S, bool CA>
__global__ void __launch_bounds__(kThreads, 1) stream_warp_ring(const __nv_bfloat16* W,
                                                                 int slices, long long* cycles,
                                                                 uint32_t* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + warp * S * 16 * kSliceK;
  const long long t0 = clock64();
  auto issue = [&](int g) {
    if (g < slices) {
      const int t = g / 6 % 27, ks = g % 6;
      __nv_bfloat16* st = ring + (g % S) * 16 * kSliceK;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = lane + 32 * u, r = q >> 3, c = q & 7;
        const __nv_bfloat16* src =
            W + (size_t)(t * 192 + warp * 16 + r) * kK + ks * kSliceK + 8 * c;
        if (CA)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                       ::"r"(smem_addr(st + sw128_at(r, c))), "l"(src));
        else
          cp_async16(st + sw128_at(r, c), src, true);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  uint32_t acc = 0;
  for (int g = 0; g < slices; ++g) {
    cp_async_wait<S - 2>();
    __syncwarp();
    issue(g + S - 1);
    const uint4* st = reinterpret_cast<const uint4*>(ring + (g % S) * 16 * kSliceK);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= st[lane + 32 * u].x ^ st[lane + 32 * u].w;
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

template <int ILP>
__global__ void __launch_bounds__(kThreads, 1) stream_ldg(const __nv_bfloat16* W, int slices,
                                                          long long* cycles, uint32_t* sink) {
  const long long t0 = clock64();
  const uint4* w = reinterpret_cast<const uint4*>(W);
  constexpr int per_pass = kRows * kK / 8;   // 16-byte chunks of W
  const int total = slices / 162 * per_pass;
  uint32_t acc = 0;
  for (int q0 = threadIdx.x; q0 < total; q0 += ILP * kThreads) {
    uint4 v[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int q = q0 + u * kThreads;
      v[u] = q < total ? __ldg(w + q % per_pass) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) acc ^= v[u].x ^ v[u].w;
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

// TILED: W laid out slice after slice (one contiguous 24 KB copy a slice);
// else one 128-byte bulk copy a weight row into rows 144 bytes apart.
template <bool TILED>
__global__ void __launch_bounds__(kThreads, 1) stream_bulk(const __nv_bfloat16* W, int slices,
                                                           long long* cycles, uint32_t* sink) {
  constexpr int S = 4, RS = 192, RowB = TILED ? 128 : 144, StageB = RS * RowB;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * StageB);
  const long long t0 = clock64();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int g) {
    if (g >= slices || threadIdx.x >= 32) return;
    const int t = g / 6 % 27, ks = g % 6;
    unsigned char* st = smem + (g % S) * StageB;
    if (threadIdx.x == 0) mbar_expect(full + g % S, RS * 128);
    __syncwarp();
    if (TILED) {
      if (threadIdx.x == 0)
        bulk_copy(st, W + (size_t)(g % 162) * RS * kSliceK, RS * 128, full + g % S);
    } else {
      for (int r = threadIdx.x; r < RS; r += 32)
        bulk_copy(st + r * RowB, W + (size_t)(t * RS + r) * kK + ks * kSliceK, 128, full + g % S);
    }
  };
  for (int s = 0; s < S - 1; ++s) issue(s);
  uint32_t acc = 0;
  for (int g = 0; g < slices; ++g) {
    mbar_wait(full + g % S, (g / S) & 1);
    __syncthreads();
    issue(g + S - 1);
    const unsigned char* st = smem + (g % S) * StageB;
    for (int q = threadIdx.x; q < RS * 8; q += kThreads)
      acc ^= reinterpret_cast<const uint4*>(st + (q >> 3) * RowB)[q & 7].x;
  }
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

template <typename Kernel>
int launch(Kernel k, int smem, int blocks, const void* W, int slices, void* cycles, void* sink) {
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<blocks, kThreads, smem>>>(static_cast<const __nv_bfloat16*>(W), slices,
                                static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int probe(int kind, int blocks, const void* W, int slices, void* cycles, void* sink) {
  switch (kind) {
    case 0: return launch(stream_cp_async<3, 192>, 3 * 24576, blocks, W, slices, cycles, sink);
    case 1: return launch(stream_cp_async<4, 192>, 4 * 24576, blocks, W, slices, cycles, sink);
    case 2: return launch(stream_cp_async<8, 96>, 8 * 12288, blocks, W, slices, cycles, sink);
    case 3: return launch(stream_ldg<8>, 0, blocks, W, slices, cycles, sink);
    case 4: return launch(stream_bulk<false>, 4 * 192 * 144 + 64, blocks, W, slices, cycles, sink);
    case 5: return launch(stream_bulk<true>, 4 * 24576 + 64, blocks, W, slices, cycles, sink);
    case 6: return launch(stream_ldg<4>, 0, blocks, W, slices, cycles, sink);
    case 7: return launch(stream_warp_ring<4, false>, 48 * 2048, blocks, W, slices, cycles, sink);
    case 8: return launch(stream_warp_ring<6, false>, 72 * 2048, blocks, W, slices, cycles, sink);
    case 9: return launch(stream_warp_ring<8, false>, 96 * 2048, blocks, W, slices, cycles, sink);
    case 10: return launch(stream_warp_ring<4, true>, 48 * 2048, blocks, W, slices, cycles, sink);
    default: return (int)cudaErrorInvalidValue;
  }
}
'''

KINDS = ('cp.async S=3', 'cp.async S=4', 'cp.async 12K S=8', 'ld.v4', 'bulk rows', 'bulk tiled',
         'ld.v4 ILP 4', 'warp ring S=4', 'warp ring S=6', 'warp ring S=8', 'warp ring .ca S=4')


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('torch_ar_decode_stream_probe: needs a CUDA card')
    card = card_line()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = BUILD_DIR / 'ar_stream_probe.cu', BUILD_DIR / 'libar_stream_probe.so'
    cu.write_text(SOURCE)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, str(cu), '-o', str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    dev = torch.device('cuda')
    W = torch.randn(ROWS, K, device=dev).to(torch.bfloat16)
    tiled = W.view(27, 192, 6, 64).permute(0, 2, 1, 3).contiguous()  # slice after slice
    cycles = torch.zeros(256, dtype=torch.int64, device=dev)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    slices = 162 * PASSES
    result = {'card': card, 'bytes_per_block': slices * SLICE_BYTES, 'kinds': {}}
    print(f'B1 weight stream probe: {slices} slices of {SLICE_BYTES} B a block [{card}]')
    for kind, name in enumerate(KINDS):
        src = tiled if name == 'bulk tiled' else W
        row = {}
        for blocks in (1, 128):
            for _ in range(2):  # the first call warms L2
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                # the 12 KB slices: twice as many for the same bytes
                rc = lib.probe(kind, blocks, src.data_ptr(), slices * (2 if kind == 2 else 1),
                               cycles.data_ptr(),
                               sink.data_ptr())
                end.record()
                if rc:
                    raise RuntimeError(f'{name}: cuda error {rc}')
                torch.cuda.synchronize()
            cyc = float(cycles[:blocks].float().mean())
            row[blocks] = {'bytes_per_cycle_sm': slices * SLICE_BYTES / cyc,
                           'ms': start.elapsed_time(end), 'cycles': cyc}
        result['kinds'][name] = row
        print(f'{name:18s} one block {row[1]["bytes_per_cycle_sm"]:6.1f} B/cycle '
              f'({row[1]["ms"]:.4f} ms), 128 blocks {row[128]["bytes_per_cycle_sm"]:6.1f} '
              f'B/cycle an SM ({row[128]["ms"]:.4f} ms)', flush=True)
    print(card)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
