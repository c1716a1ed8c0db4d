// Causal online-softmax attention forward with GQA for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_pallas`, body `_flash_kernel`): q [B*H, Sq, dh] against
// k, v [B*KV, Skv, dh]; program bh reads kv row bh / (B*H / B*KV), the
// BlockSpec mapping of the TPU kernel, so grouped query heads stream the same
// kv rows and nothing is repeated. Each of q, k, v and o is addressed through
// its own (batch, head, row) strides with unit stride along dh, so the model's
// [B, S, H, dh] projections are read, and its output written, in place. It computes what `_flash_kernel` computes:
// q cast to f32 and scaled by f32(1/sqrt(dh)); s = q k^T in f32; with
// `causal` the diagonal is anchored bottom-right (q row i sees kv columns
// <= Skv - Sq + i) and masked scores are NEG_INF = -1e30; the running max,
// denominator and accumulator are f32 (the recurrence of kernel.py:57-75);
// p is cast to v's dtype before the PV product; a row with no visible column
// has l = 0, taken as 1, and outputs 0. The output is in q's dtype. bf16 or
// f32 in, dh 64 or 128, any Sq and Skv (tails masked).
//
// What bounds it on this card: two products of 2 * dh operations for each
// visible (q, kv) pair. At the causal LM's per-layer shape (q [128, 2048, 64],
// k/v [64, 2048, 64], bf16) that is ~69 GFLOP against ~100 MB of q, k, v and
// o: ~690 FLOP a byte, far above the bf16 tensor-core ridge (~295), so it is
// bound by operations, 0.07 ms at 989 TFLOP/s.
//
// Design (a simple first version): one block of 256 threads per
// (64-row q tile, bh). The scaled q tile is staged once, in f32, transposed
// ([dh][64]); kv tiles of 64 rows are staged one after another, K transposed
// and V row-major, converted to f32 as they land. Each thread owns a 4 x 4
// register tile of scores (rows ty*4.., columns tx*4..) in plain f32 FMA; the
// 16 threads of a row reduce its max and sum with shuffles, so the running
// max, denominator and the rescale of the accumulator stay in registers. P
// goes through shared memory (rounded to v's dtype) into the PV product,
// where each thread accumulates its 4 rows x dh/16 output columns. kv tiles
// wholly above the diagonal are never visited (the TPU kernel's `pl.when`
// skip); q tiles are walked heaviest first. No tensor cores: mma / wgmma and
// TMA are for a later change, so the kernel runs at the f32 FMA rate, far
// from the bf16 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int BQ = 64;                    // q rows per block
constexpr int BK = 64;                    // kv rows per tile
constexpr int TR = 4;                     // rows per thread
constexpr int TC = 4;                     // score columns per thread
constexpr int NTX = BK / TC;              // threads along columns (16)
constexpr int NTY = BQ / TR;              // threads along rows (16)
constexpr int THREADS = NTX * NTY;        // 256
constexpr int LD = 68;                    // padded row of the 64-wide tiles
constexpr float NEG_INF = -1e30f;
constexpr int MAX_GRID_Y = 65535;

template <int DH>
struct Layout {
  static constexpr size_t qt = (size_t)DH * LD;     // q^T [DH][LD], scaled
  static constexpr size_t kt = (size_t)DH * LD;     // k^T [DH][LD]
  static constexpr size_t vs = (size_t)BK * DH;     // v [BK][DH]
  static constexpr size_t ps = (size_t)BQ * LD;     // p [BQ][LD]
  static constexpr size_t bytes = sizeof(float) * (qt + kt + vs + ps);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// p as the PV product sees it: cast to v's dtype.
__device__ __forceinline__ float as_v(float x, const float*) { return x; }
__device__ __forceinline__ float as_v(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (batch, head, row) strides of one tensor, in elements.
struct Strides {
  long long b, h, r;
};

struct AllStrides {
  Strides q, k, v, o;
};

// Rows [0, nrows) of src (rows `ld` elements apart, DH wide) times mul into
// dst [DH][LD] (transposed), zeros past nrows. Lanes walk rows, so the
// transposed stores hit consecutive banks.
template <typename T, int DH>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ src,
                                                 long long ld, int nrows,
                                                 float mul, float* dst) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < 64 * D4; i += THREADS) {
    const int r = i % 64, d4 = i / 64;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = load4(src + r * ld + 4 * d4);
    float* col = dst + (size_t)(4 * d4) * LD + r;
    col[0] = x.x * mul;
    col[LD] = x.y * mul;
    col[2 * LD] = x.z * mul;
    col[3 * LD] = x.w * mul;
  }
}

// Rows [0, nrows) of src (rows `ld` elements apart, DH wide) into
// dst [BK][DH], zeros past nrows.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           long long ld, int nrows,
                                           float* dst) {
  constexpr int D4 = DH / 4;
  for (int i = threadIdx.x; i < BK * D4; i += THREADS) {
    const int r = i / D4, d4 = i % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = load4(src + r * ld + 4 * d4);
    reinterpret_cast<float4*>(dst)[i] = x;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, AllStrides st, int BH, int H, int group, int Sq,
    int Skv, int causal, float scale) {
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
    const T* kb = k + b * st.k.b + hk * st.k.h;
    const T* vb = v + b * st.v.b + hk * st.v.h;
    __syncthreads();                      // the last bh is done with qt
    stage_transposed<T, DH>(q + b * st.q.b + h * st.q.h + q0 * st.q.r,
                            st.q.r, nq, scale, qt);

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
      stage_transposed<T, DH>(kb + k0 * st.k.r, st.k.r, nk, 1.f, kt);
      stage_rows<T, DH>(vb + k0 * st.v.r, st.v.r, nk, vs);
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
            make_float4(as_v(s[i][0], v), as_v(s[i][1], v),
                        as_v(s[i][2], v), as_v(s[i][3], v));
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

    T* ob = o + b * st.o.b + h * st.o.h + q0 * st.o.r;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty * TR + i;
      if (r >= nq) continue;
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int g = 0; g < NC4; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store(ob + r * st.o.r + g * 64 + tx * 4 + c,
                acc[i][g * 4 + c] / li);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const AllStrides& st, int B, int H, int KV, int Sq, int Skv,
           int causal, void* stream) {
  const int BH = B * H;
  const size_t smem = Layout<DH>::bytes;
  cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const float scale = (float)(1.0 / sqrt((double)DH));
  dim3 grid((Sq + BQ - 1) / BQ, BH < MAX_GRID_Y ? BH : MAX_GRID_Y);
  if (BH > 0 && Sq > 0)
    flash_attention_kernel<T, DH>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(o), st, BH, H,
            H / KV, Sq, Skv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, dh]; k, v [B, KV, Skv, dh]; o [B, H, Sq, dh]; all of one
// dtype (f32, or bf16 when is_bf16), each addressed through its (batch, head,
// row) strides in elements, strides[12] = q, k, v, o in turn, with unit
// stride along dh; base pointers and strides 16-byte aligned; H % KV == 0,
// dh 64 or 128. Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Skv, int dh,
                                      const long long* strides, int causal,
                                      int is_bf16, void* stream) {
  if (B < 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  AllStrides st;
  Strides* each[4] = {&st.q, &st.k, &st.v, &st.o};
  for (int t = 0; t < 4; ++t)
    *each[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  if (dh == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, st, B, H, KV, Sq,
                                               Skv, causal, stream)
                   : launch<float, 64>(q, k, v, o, st, B, H, KV, Sq, Skv,
                                       causal, stream);
  if (dh == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, st, B, H, KV, Sq,
                                                Skv, causal, stream)
                   : launch<float, 128>(q, k, v, o, st, B, H, KV, Sq, Skv,
                                        causal, stream);
  return (int)cudaErrorInvalidValue;
}
