// 3xTF32 products on the tensor cores, and the copies that feed them.
//
// A finite f32 value x splits into hi = tf32(x) and lo = x - hi, which the
// tensor cores read truncated to TF32, so that x = hi + lo to ~2^-21
// relative; a product a . b is then taken as
// lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) (the lo . lo term is below f32's
// rounding) on `mma.sync.m16n8k8` with f32 accumulators: f32's accuracy at
// the TF32 rate over three passes.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A [16 x 8] row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                         a3 (g + 8, t + 4);
//   B [8 x 8] column-major: b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//               c3 (g + 8, 2t + 1).
#pragma once
#include <cstdint>

// TF32 rounding of a finite x, to nearest with ties away from zero: the
// result of `cvt.rna.tf32.f32`, in two integer operations (the instruction
// compiles to four, checking for inf and NaN, which token vectors do not
// hold): half a TF32 ulp added to the magnitude bits, then truncated.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), each a TF32 bit pattern
// x -> (hi, lo) as TF32 operands: hi rounded, lo = x - hi (exact in f32)
// as it is: the tensor cores read the top 19 bits of an operand, so lo
// enters truncated to TF32 (|lo| <= 2^-11 |x|: that costs < 2^-21 |x|,
// and saves the rounding's two operations a value). maxsim_packed.cu
// rounds its lo parts with to_tf32 as well.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores: A [16 x 8] row-major, B [8 x 8]
// column-major, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[m][n] += a[m] . b[n] in 3xTF32 for M x N tiles: the small terms first,
// each of the three passes over every tile before the next (the passes on
// one accumulator depend on each other; a warp issues in order, so
// interleaving the tiles keeps the tensor cores fed).
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32_tiles(
    float (&d)[M][N][4], const uint32_t (&ah)[M][4],
    const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
    const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(d[m][n], ah[m], bh[n][0], bh[n][1]);
}

// Four 8 x 4 tiles of 32-bit values from shared memory, one per group of 8
// lanes (lane l passes the address of row l % 8 of tile l / 8); lane
// (g, t) receives word t of row g of each tile: the TF32 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// *a = max(*a, v) in shared memory: non-negative floats order as signed
// integers, negative ones in reverse as unsigned.
__device__ __forceinline__ void atomic_max(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

// 16 bytes global -> shared without a register stop (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes global -> shared (both 4-byte aligned), through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// this thread's copies have landed (others' need a barrier after it)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's copies have landed, but for its N newest groups
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
