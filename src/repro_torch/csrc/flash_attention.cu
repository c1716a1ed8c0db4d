// Causal online-softmax attention forward with GQA for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_pallas`, body `_flash_kernel`): q [B*H, Sq, dh] against
// k, v [B*KV, Skv, dh]; program bh reads kv head h / (H / KV), the BlockSpec
// mapping of the TPU kernel, so grouped query heads stream the same kv rows
// and nothing is repeated. Each of q, k, v and o is addressed through its
// own (batch, head, row) strides with unit stride along dh, so the model's
// [B, S, H, dh] projections are read, and its output written, in place.
// Both bodies keep `_flash_kernel`'s contract: with `causal` the diagonal is
// anchored bottom-right (q row i sees kv columns <= Skv - Sq + i) and masked
// scores are NEG_INF = -1e30; the running max, denominator and accumulator
// are f32 (the recurrence of kernel.py:57-75); p is rounded to v's dtype
// before the PV product, which accumulates in f32; a row with no visible
// column has l = 0, taken as 1, and outputs 0. The output is in q's dtype.
// dh 64, 112 (Kimi K2's 7,168 / 64 heads; bf16 only) or 128, any Sq and Skv
// (tails masked). The softmax scale is the caller's: f32(1/sqrt(dh)) of the
// true dh, which the wrapper also passes when it zero-pads an f32 dh of 112
// to the f32 body's 128 (the padded columns add 0 to q k^T and their output
// columns are cut off).
//
// What bounds it on this card: two products of 2 * dh operations for each
// visible (q, kv) pair. At the causal LM's per-layer shape (q [128, 2048, 64],
// k/v [64, 2048, 64], bf16) that is ~69 GFLOP against ~100 MB of q, k, v and
// o: ~690 FLOP a byte, far above the bf16 tensor-core ridge (~295), so it is
// bound by operations, 0.07 ms at 989 TFLOP/s: f32 FMAs outside the tensor
// cores (67 TFLOP/s at most) are 15x short of it, so bf16 inputs run on the
// tensor cores.
//
// Which dtype takes which body:
//
// * bf16 (every model path): `flash_bf16_kernel`, on the tensor cores. One
//   block of NWARPS warps per (bh, BQ = 16 * NWARPS q rows); each warp owns
//   16 q rows. QK^T and PV are `mma.sync.m16n8k16` bf16 -> f32 products whose
//   operands come from shared memory by `ldmatrix` (V by `ldmatrix.trans`);
//   shared rows are padded by 16 bytes, so the eight rows an `ldmatrix` reads
//   fall in distinct bank groups. The q tile is loaded once and held as A
//   fragments in registers. K/V tiles of 64 rows are double-buffered with
//   16-byte `cp.async` (zero-filled past Skv), so the next tile loads while
//   the current one computes. S stays in the accumulator fragments: it is
//   scaled, masked (only on tiles that cross the diagonal or the Skv tail),
//   and the online softmax runs on it with the row max and sum taken across
//   the four lanes that share a row; p is rounded to bf16 in registers and
//   reused as the A operand of PV, never touching shared memory. A warp skips
//   the products of a kv tile that lies wholly above its rows' diagonal, a
//   block never visits kv tiles above its last row's, and q tiles are walked
//   heaviest first. Scaling: q and k are bf16, so each product is exact in
//   f32 and S is scaled by f32(1/sqrt(dh)) right after QK^T. At dh = 64 the
//   scale is 0.125, a power of two, so this equals `_flash_kernel`'s scaling
//   of q before the product; at dh = 112 and 128 the two differ by one f32
//   rounding of each score.
//   The block height follows dh (`bf16_warps`): 128 q rows (8 warps) at
//   dh 64, 64 rows (4 warps) at dh 112 and 128, the faster of the two at
//   dh 64 and 128 on an H100. At dh 112 a row is 7 k-steps and 14 output
//   tiles, 14 16-byte chunks (a 240-byte padded shared row, so the eight rows
//   of an `ldmatrix` still fall in distinct bank groups).
// * f32 (tests and `chip_smoke.py` only, dh 64 or 128): `flash_f32_kernel`,
//   f32 FMAs,
//   because the tensor cores cannot hold the f32 contract: one block of 256
//   threads per (64-row q tile, bh), q scaled in f32 before the product,
//   4 x 4 f32 FMA register tiles from shared memory, P through shared
//   memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_GRID_Y = 65535;

// (batch, head, row) strides of one tensor, in elements.
struct Strides {
  long long b, h, r;
};

struct AllStrides {
  Strides q, k, v, o;
};

// ---------------------------------------------------------------- f32 body

constexpr int BQ = 64;                    // q rows per block
constexpr int BK = 64;                    // kv rows per tile
constexpr int TR = 4;                     // rows per thread
constexpr int TC = 4;                     // score columns per thread
constexpr int NTX = BK / TC;              // threads along columns (16)
constexpr int NTY = BQ / TR;              // threads along rows (16)
constexpr int THREADS = NTX * NTY;        // 256
constexpr int LD = 68;                    // padded row of the 64-wide tiles

template <int DH>
struct Layout {
  static constexpr size_t qt = (size_t)DH * LD;     // q^T [DH][LD], scaled
  static constexpr size_t kt = (size_t)DH * LD;     // k^T [DH][LD]
  static constexpr size_t vs = (size_t)BK * DH;     // v [BK][DH]
  static constexpr size_t ps = (size_t)BQ * LD;     // p [BQ][LD]
  static constexpr size_t bytes = sizeof(float) * (qt + kt + vs + ps);
};

// Rows [0, nrows) of src (rows `ld` elements apart, DH wide) times mul into
// dst [DH][LD] (transposed), zeros past nrows. Lanes walk rows, so the
// transposed stores hit consecutive banks.
template <int DH>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ src,
                                                 long long ld, int nrows,
                                                 float mul, float* dst) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < 64 * D4; i += THREADS) {
    const int r = i % 64, d4 = i / 64;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = *reinterpret_cast<const float4*>(src + r * ld + 4 * d4);
    float* col = dst + (size_t)(4 * d4) * LD + r;
    col[0] = x.x * mul;
    col[LD] = x.y * mul;
    col[2 * LD] = x.z * mul;
    col[3 * LD] = x.w * mul;
  }
}

// Rows [0, nrows) of src (rows `ld` elements apart, DH wide) into
// dst [BK][DH], zeros past nrows.
template <int DH>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           long long ld, int nrows,
                                           float* dst) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < BK * D4; i += THREADS) {
    const int r = i / D4, d4 = i % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = *reinterpret_cast<const float4*>(src + r * ld + 4 * d4);
    reinterpret_cast<float4*>(dst)[i] = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, AllStrides st,
    int BH, int H, int group, int Sq, int Skv, int causal, float scale) {
  constexpr int TD = DH / NTX;            // output columns per thread
  constexpr int NC4 = TD / 4;             // their float4 groups (1 or 2)
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + Layout<DH>::qt;
  float* vs = kt + Layout<DH>::kt;
  float* ps = vs + Layout<DH>::vs;

  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int nq = min(BQ, Sq - q0);
  const int q_offset = Skv - Sq;          // bottom-right causal anchor
  // kv columns this tile can see: [0, kv_end)
  const int kv_end = causal ? min(Skv, q0 + nq + q_offset) : Skv;

  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const int b = bh / H, h = bh % H, hk = h / group;
    const float* kb = k + b * st.k.b + hk * st.k.h;
    const float* vb = v + b * st.v.b + hk * st.v.h;
    __syncthreads();                      // the last bh is done with qt
    stage_transposed<DH>(q + b * st.q.b + h * st.q.h + q0 * st.q.r, st.q.r,
                         nq, scale, qt);

    float m[TR], l[TR], acc[TR][TD];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < kv_end; k0 += BK) {
      const int nk = min(BK, Skv - k0);
      __syncthreads();                    // the last tile's PV is done
      stage_transposed<DH>(kb + k0 * st.k.r, st.k.r, nk, 1.f, kt);
      stage_rows<DH>(vb + k0 * st.v.r, st.v.r, nk, vs);
      __syncthreads();

      float s[TR][TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float4 a =
            *reinterpret_cast<const float4*>(qt + d * LD + ty * TR);
        const float4 b =
            *reinterpret_cast<const float4*>(kt + d * LD + tx * TC);
        const float av[TR] = {a.x, a.y, a.z, a.w};
        const float bv[TC] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }

      // mask, then the online-softmax update of each of this thread's rows
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int row = q0 + ty * TR + i + q_offset;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int col = k0 + tx * TC + j;
          if (col >= Skv || (causal && row < col)) s[i][j] = NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = NTX / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float p = s[i][j] <= NEG_INF ? 0.f : expf(s[i][j] - m_new);
          rs += p;
          s[i][j] = p;
        }
#pragma unroll
        for (int off = NTX / 2; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
        *reinterpret_cast<float4*>(ps + (ty * TR + i) * LD + tx * TC) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncthreads();

      // acc += p v over the tile's rows (rows past nk: p = 0, v = 0)
      const int kk_end = (nk + 3) & ~3;
      for (int kk = 0; kk < kk_end; kk += 4) {
        float4 p4[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          p4[i] = *reinterpret_cast<const float4*>(ps + (ty * TR + i) * LD +
                                                   kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int g = 0; g < NC4; ++g) {
            const float4 b = *reinterpret_cast<const float4*>(
                vs + (kk + e) * DH + g * 64 + tx * 4);
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float a = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                            : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[i][g * 4 + c] = fmaf(a, bv[c], acc[i][g * 4 + c]);
            }
          }
        }
      }
    }

    float* ob = o + b * st.o.b + h * st.o.h + q0 * st.o.r;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty * TR + i;
      if (r >= nq) continue;
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int g = 0; g < NC4; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ob[r * st.o.r + g * 64 + tx * 4 + c] = acc[i][g * 4 + c] / li;
    }
  }
}

// --------------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;                    // bf16 padding of a shared row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, nvalid) of src (rows `ld` elements apart, DH wide) into the
// shared tile dst [ROWS][DH + PAD] by cp.async, zeros past nvalid; `base` is
// any readable address, named for the rows that are not read.
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_tile(const bf16* src, long long ld,
                                          int nvalid, bf16* dst,
                                          const bf16* base) {
  constexpr int CPR = DH / 8;             // 16-byte chunks a row
  static_assert(ROWS * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NT; ++n) {
    const int i = threadIdx.x + n * NT;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nvalid;
    cp_async16(smem_u32(dst + r * (DH + PAD) + c * 8),
               ok ? src + r * ld + c * 8 : base, ok);
  }
}

template <int DH, int NWARPS>
struct Bf16Layout {
  static constexpr int BQ = 16 * NWARPS;
  static constexpr int LDS = DH + PAD;
  static constexpr size_t bytes = sizeof(bf16) * (size_t)LDS * (BQ + 4 * BK);
};

template <int DH, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, AllStrides st, int H,
    int group, int Sq, int Skv, int causal, float scale) {
  constexpr int NT = NWARPS * 32;
  constexpr int BQ = Bf16Layout<DH, NWARPS>::BQ;
  constexpr int LDS = Bf16Layout<DH, NWARPS>::LDS;
  constexpr int KS = DH / 16;             // k-steps of QK^T
  constexpr int NS = BK / 8;              // 8-column tiles of S
  constexpr int NO = DH / 8;              // 8-column tiles of O
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);      // [BQ][LDS]
  bf16* ks = qs + BQ * LDS;                       // [2][BK][LDS]
  bf16* vs = ks + 2 * BK * LDS;                   // [2][BK][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row, column pair
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int nq = min(BQ, Sq - q0);
  const int q_offset = Skv - Sq;          // bottom-right causal anchor
  const int kv_end = causal ? min(Skv, q0 + nq + q_offset) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  // the causal row of this warp's first q row; its rows are rw .. rw + 15
  const int rw = q0 + warp * 16 + q_offset;

  const bf16* qb = q + b * st.q.b + h * st.q.h;
  const bf16* kb = k + b * st.k.b + hk * st.k.h;
  const bf16* vb = v + b * st.v.b + hk * st.v.h;
  load_tile<DH, BQ, NT>(qb + q0 * st.q.r, st.q.r, nq, qs, qb);
  if (n_tiles > 0) {
    load_tile<DH, BK, NT>(kb, st.k.r, min(BK, Skv), ks, kb);
    load_tile<DH, BK, NT>(vb, st.v.r, min(BK, Skv), vs, vb);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8
  uint32_t qf[KS][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {               // the next tile loads meanwhile
      const int k1 = k0 + BK, nb = (it + 1) & 1;
      load_tile<DH, BK, NT>(kb + k1 * st.k.r, st.k.r, min(BK, Skv - k1),
                            ks + nb * BK * LDS, kb);
      load_tile<DH, BK, NT>(vb + k1 * st.v.r, st.v.r, min(BK, Skv - k1),
                            vs + nb * BK * LDS, vb);
    }
    cp_async_commit();                    // (an empty group on the last)
    cp_async_wait<1>();                   // this tile (and q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                         (lane >> 4) * 8),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }
    const bf16* kt = ks + (it & 1) * BK * LDS;
    const bf16* vt = vs + (it & 1) * BK * LDS;

    if (!(causal && k0 > rw + 15)) {      // else no row of the warp sees it
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = q k^T: B fragments of two 8-column tiles per ldmatrix.x4
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    LDS +
                           kk * 16 + ((lane >> 3) & 1) * 8),
                  b0, b1, b2, b3);
          mma_bf16(s[2 * np], qf[kk], b0, b1);
          mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
        }

      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > rw);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale;
          if (edge) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = rw + g + (e >> 1) * 8;
            if (col >= Skv || (causal && row < col)) s[j][e] = NEG_INF;
          }
        }

      // online softmax on the fragments: a row's 16 columns of this tile
      // lie in the four lanes 4g .. 4g + 3
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f((m[r] - m_new) * LOG2E);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p =
                s[j][e] <= NEG_INF ? 0.f : exp2f((s[j][e] - m_new) * LOG2E);
            rs += p;
            s[j][e] = p;
          }
        l[r] = l[r] * alpha + rs;         // this lane's part; summed at the end
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // O += p v: the S fragments of two 8-column tiles, rounded to bf16,
      // are the A fragment of one 16-deep k-step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pf[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(
              smem_u32(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDS +
                       dp * 16 + (lane >> 4) * 8),
              b0, b1, b2, b3);
          mma_bf16(acc[2 * dp], pf, b0, b1);
          mma_bf16(acc[2 * dp + 1], pf, b2, b3);
        }
      }
    }
    __syncthreads();                      // done with this buffer
  }
  cp_async_wait<0>();                     // (q alone, when no tile is seen)

  bf16* ob = o + b * st.o.b + h * st.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float li = lr == 0.f ? 1.f : lr;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < Sq) {
      bf16* orow = ob + row * st.o.r;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r] / li, acc[n][2 * r + 1] / li);
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const AllStrides& st, int B, int H, int KV, int Sq, int Skv,
               int causal, float scale, void* stream) {
  const int BH = B * H;
  const size_t smem = Layout<DH>::bytes;
  cudaFuncSetAttribute(flash_f32_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((Sq + BQ - 1) / BQ, BH < MAX_GRID_Y ? BH : MAX_GRID_Y);
  if (BH > 0 && Sq > 0)
    flash_f32_kernel<DH><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st, BH, H,
        H / KV, Sq, Skv, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH, int NWARPS>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const AllStrides& st, int B, int H, int KV, int Sq, int Skv,
                int causal, float scale, void* stream) {
  constexpr int BQb = Bf16Layout<DH, NWARPS>::BQ;
  const size_t smem = Bf16Layout<DH, NWARPS>::bytes;
  cudaFuncSetAttribute(flash_bf16_kernel<DH, NWARPS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int n_q = (Sq + BQb - 1) / BQb;
  if (n_q > MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  dim3 grid(B * H, n_q);
  if (B * H > 0 && Sq > 0)
    flash_bf16_kernel<DH, NWARPS>
        <<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), st, H,
            H / KV, Sq, Skv, causal, scale);
  return (int)cudaGetLastError();
}

// Warps of a bf16 block (16 q rows each) by dh.
template <int DH>
constexpr int bf16_warps() {
  return DH == 64 ? 8 : 4;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const AllStrides& st, int B, int H, int KV, int Sq, int Skv,
           int causal, int is_bf16, float scale, void* stream) {
  if (!is_bf16)
    return launch_f32<DH>(q, k, v, o, st, B, H, KV, Sq, Skv, causal, scale,
                          stream);
  return launch_bf16<DH, bf16_warps<DH>()>(q, k, v, o, st, B, H, KV, Sq, Skv,
                                           causal, scale, stream);
}

}  // namespace

// q [B, H, Sq, dh]; k, v [B, KV, Skv, dh]; o [B, H, Sq, dh]; all of one
// dtype (f32, or bf16 when is_bf16), each addressed through its (batch, head,
// row) strides in elements, strides[12] = q, k, v, o in turn, with unit
// stride along dh; base pointers and strides 16-byte aligned; H % KV == 0,
// dh 64 or 128, or 112 in bf16; `scale` multiplies q k^T (f32(1/sqrt(dh)) of
// the true dh). Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Skv, int dh,
                                      const long long* strides, int causal,
                                      int is_bf16, float scale, void* stream) {
  if (B < 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  AllStrides st;
  Strides* each[4] = {&st.q, &st.k, &st.v, &st.o};
  for (int t = 0; t < 4; ++t)
    *each[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  if (dh == 64)
    return launch<64>(q, k, v, o, st, B, H, KV, Sq, Skv, causal, is_bf16,
                      scale, stream);
  if (dh == 112 && is_bf16)
    return launch_bf16<112, bf16_warps<112>()>(q, k, v, o, st, B, H, KV, Sq,
                                               Skv, causal, scale, stream);
  if (dh == 128)
    return launch<128>(q, k, v, o, st, B, H, KV, Sq, Skv, causal, is_bf16,
                       scale, stream);
  return (int)cudaErrorInvalidValue;
}
