#!/usr/bin/env python3
"""Throughput of the tensor-core instruction the port's 3xTF32 kernels use.

    python3 tools/mma_sync_peak.py        # one CUDA card, nvcc on PATH
                                          # or under $CUDA_HOME

Builds a small CUDA program (below) into ``build/tools`` and runs it: each
warp issues ``mma.sync.aligned.m16n8k8`` with TF32 operands (and, for
comparison, the bf16 ``m16n8k16``) on independent register accumulators,
one block of 8 warps per SM, and the program prints the achieved TFLOP/s,
for the three passes of a 3xTF32 product issued depth-first (the three
products on one accumulator back to back) and breadth-first (each pass
over every accumulator before the next). The kernels of
``src/repro_torch/csrc`` cannot issue their products faster than these
rates; the published dense TF32 peak (494.7 TFLOP/s) is what ``wgmma``
reaches. Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MODE 0: one TF32 product an accumulator a step; 1: three, depth-first;
// 2: three, breadth-first; 3: one bf16 product
template <int MODE>
__global__ void bench(float* out, int iters, uint32_t s) {
  constexpr int CH = 16;                 // accumulators a warp
  float acc[CH][4] = {};
  const uint32_t a[4] = {s, s + 1, s + 2, s + 3};
  const uint32_t l[4] = {s + 7, s, s + 9, s + 2};
  const uint32_t b0 = s * 3, b1 = s * 5;
  for (int i = 0; i < iters; ++i) {
    if (MODE == 0 || MODE == 3) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (MODE == 0) mma_tf32(acc[c], a, b0, b1); else mma_bf16(acc[c], a, b0, b1);
    } else if (MODE == 1) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        mma_tf32(acc[c], l, b0, b1);
        mma_tf32(acc[c], a, b1, b0);
        mma_tf32(acc[c], a, b0, b1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_tf32(acc[c], l, b0, b1);
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_tf32(acc[c], a, b1, b0);
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_tf32(acc[c], a, b0, b1);
    }
  }
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) t += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

template <int MODE>
double run(int sms) {
  const int warps = 8, iters = 2048, per = (MODE == 1 || MODE == 2) ? 3 : 1;
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * warps * 32);
  bench<MODE><<<sms, warps * 32>>>(out, 16, 1);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<MODE><<<sms, warps * 32>>>(out, iters, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  const double flop_mma = MODE == 3 ? 4096.0 : 2048.0;  // 2 m n k
  return (double)sms * warps * iters * 16 * per * flop_mma / (ms * 1e9);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  printf("mma.sync m16n8k8 TF32, one product an accumulator: %.1f TFLOP/s\n", run<0>(sms));
  printf("3xTF32 passes depth-first: %.1f TFLOP/s\n", run<1>(sms));
  printf("3xTF32 passes breadth-first: %.1f TFLOP/s\n", run<2>(sms));
  printf("mma.sync m16n8k16 bf16: %.1f TFLOP/s\n", run<3>(sms));
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        print("mma_sync_peak: nvcc not found", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(root, "build", "tools")
    os.makedirs(out, exist_ok=True)
    src, exe = os.path.join(out, "mma_sync_peak.cu"), os.path.join(
        out, "mma_sync_peak")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, src], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
