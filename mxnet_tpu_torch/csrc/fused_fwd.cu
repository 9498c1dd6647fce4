// Kernel A: fused scale/shift(+ReLU) -> matmul (+bias) (+residual) with
// per-column statistics of the stored output.
//
//   y[m, n]  = sum_k a[m, k] * W[n, k] (+ bias[n]) (+ residual[m, n])
//   a[m, k]  = [relu](x[m, k] * scale[k] + shift[k]), cast to x's dtype
//   ysum[n]  = sum_m y[m, n],  ysumsq[n] = sum_m y[m, n]^2   (of stored y)
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py `_fwd_kernel`
// (launched by `_fwd_call`), forward only: serving never differentiates.
// The weight arrives in FullyConnected's (N, K) layout (`wt=True`) and is
// contracted in place.  x is f32 or bf16; accumulation is f32.
//
// What bounds it on an H100.  At decode (M <= 16 rows: the serving slots)
// each weight element is used M times, so reading W (K*N elements) from
// device memory at 3.35 TB/s bounds it (ffn1 in f32: 16.8 MB, 5.0 us).
// At a training batch (M = 16384) it is 2*M*N*K operations: 67 TFLOP/s
// on the CUDA cores in f32, 989 TFLOP/s on the tensor cores in bf16.
//
// Design: the caller (ops/fused_kernel.py `_plan`) picks one variant.
// * decode (M <= 16): weight streaming.  Each block applies the prologue
//   once to all M rows of x (a K-chunk at a time) in shared memory; each
//   warp owns one output column, streams that column's contiguous K-row
//   of W with 16-byte loads, four in flight a lane, keeps M partial sums
//   a lane and reduces them with shuffles.  The epilogue is in the warp
//   (bias, residual, rounding), and ysum / ysumsq are written once per
//   column: deterministic, no atomics.
// * simt128 / simt64 / simt32: fused_tiles.cuh's f32 engine, the prologue
//   applied on x's way into shared memory; the tile is the largest that
//   still gives the grid about one block per SM (the serve's M = 256
//   prefill chunks take the small ones).  Column statistics reduce in the
//   tile and go out as one atomicAdd per column and tile, so they vary
//   from run to run at about one ulp.
// * wgmma128 (bf16, M large enough for 128 x 128 tiles to fill the
//   card): wgmma.mma_async, below; each thread builds its A fragments
//   from the x tile through the prologue, W is read by descriptor.
// * mma64 (bf16, the serve's M = 256 chunks): fused_tiles.cuh's mma.sync
//   engine, x cooked through the prologue into shared memory (mma128,
//   its square 128 tile, is kernel F's).
// decode and simt come with 16-byte loads, or (``_scalar``: K, N not
// multiples of the width, or pointers unaligned) scalar loads; a bf16
// shape the tensor-core variants cannot load (K or N not a multiple of 8)
// takes a simt ``_scalar`` variant, so any shape is taken.
//
// Earlier design: 64 x 64 tiles 16 deep with 4 x 4 outputs a
// thread and scalar shared-memory reads; at decode 16 x 16 tiles, one
// output a thread.  Its times stay in PERF.md (decode ffn1 f32 0.0354 ms,
// 4.8x addmm; train ffn1 f32 6.865 ms, 2.5x).
#include "fused_tiles.cuh"

namespace {

using ft::bf16;
using ft::to_f32;
using ft::from_f32;

// variant codes, as ops/fused_kernel.py VARIANTS (mma128 is kernel F's)
enum {
  V_DECODE = 0, V_DECODE_S, V_SIMT128, V_SIMT128_S, V_SIMT64, V_SIMT64_S,
  V_SIMT32, V_SIMT32_S, V_MMA128, V_MMA64, V_WGMMA
};

// ---------------------------------------------------------------------------
// decode: weight streaming for M <= 16
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 8;   // output columns a block
constexpr int DEC_UNROLL = 4;  // W loads in flight a lane

template <typename T, bool VEC>
struct WVec {
  static constexpr int N = VEC ? 16 / sizeof(T) : 1;  // elements a load
};

template <typename T, int V>
__device__ __forceinline__ void load_w(const T* p, float (&v)[V]);
template <>
__device__ __forceinline__ void load_w<float, 4>(const float* p,
                                                 float (&v)[4]) {
  ft::load4<float>(p, v);
}
template <>
__device__ __forceinline__ void load_w<bf16, 8>(const bf16* p,
                                                float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_w<float, 1>(const float* p,
                                                 float (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_w<bf16, 1>(const bf16* p,
                                                float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

// MT >= M rows of partial sums (those past M are never written out), KC
// = the K-chunk held in shared memory (MT * KC floats = 32 KB)
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, const T* __restrict__ w,
              const float* __restrict__ bias, const T* __restrict__ res,
              T* __restrict__ y, float* __restrict__ ysum,
              float* __restrict__ ysumsq, int M, int K, int N, int relu) {
  constexpr int V = WVec<T, VEC>::N;
  constexpr int KC = 8192 / MT;
  constexpr int STEP = 32 * V;  // K elements a warp covers per load
  // W loads in flight a lane: four, two where M x V partial products
  // would crowd the registers
  constexpr int U = V * MT >= 64 ? 2 : DEC_UNROLL;
  __shared__ __align__(16) float a_s[MT * KC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * DEC_WARPS + warp;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    const int kl = min(KC, K - kc);
    // the prologue over the M x kl valid elements, in groups of V along
    // k, two groups a thread in flight; rows past M are never read back
    const int per_row = kl / V, groups = M * per_row;
    __syncthreads();
    for (int g0 = tid; g0 < groups; g0 += 2 * DEC_WARPS * 32) {
      float xv[2][V];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int g = g0 + u * DEC_WARPS * 32;
        if (g < groups) {
          const int m = g / per_row, kk = (g - m * per_row) * V;
          load_w<T, V>(x + (size_t)m * K + kc + kk, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int g = g0 + u * DEC_WARPS * 32;
        if (g < groups) {
          const int m = g / per_row, kk = (g - m * per_row) * V;
#pragma unroll
          for (int e = 0; e < V; ++e)
            a_s[m * KC + kk + e] =
                ft::act<T>(xv[u][e], __ldg(scale + kc + kk + e),
                           __ldg(shift + kc + kk + e), relu);
        }
      }
    }
    __syncthreads();
    if (n < N) {
      const T* wr = w + (size_t)n * K + kc;
      for (int k0 = lane * V; k0 < kl; k0 += STEP * U) {
        float wv[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k0 + u * STEP;
          if (kk < kl) {
            load_w<T, V>(wr + kk, wv[u]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) wv[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k0 + u * STEP;
          if (kk >= kl) break;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float* ar = a_s + m * KC + kk;
            if constexpr (V == 1) {
              acc[m] = fmaf(ar[0], wv[u][0], acc[m]);
            } else {
#pragma unroll
              for (int e = 0; e < V; e += 4) {
                const float4 a4 = *reinterpret_cast<const float4*>(ar + e);
                acc[m] = fmaf(a4.x, wv[u][e], acc[m]);
                acc[m] = fmaf(a4.y, wv[u][e + 1], acc[m]);
                acc[m] = fmaf(a4.z, wv[u][e + 2], acc[m]);
                acc[m] = fmaf(a4.w, wv[u][e + 3], acc[m]);
              }
            }
          }
        }
      }
    }
  }
  if (n >= N) return;
  // every lane ends with each row's full sum; lane m finishes row m
  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == m) mine = v;
  }
  float s = 0.f, q = 0.f;
  if (lane < M) {
    float v = mine;
    if (bias) v += bias[n];
    if (res) v += to_f32(res[(size_t)lane * N + n]);
    const T out = from_f32<T>(v);
    y[(size_t)lane * N + n] = out;
    s = to_f32(out);  // statistics of the stored value
    q = s * s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (lane == 0) {
    ysum[n] = s;
    ysumsq[n] = q;
  }
}

// ---------------------------------------------------------------------------
// the tile engines: y tile at rows m0.., columns n0..
// ---------------------------------------------------------------------------

template <class C, typename T, bool VEC>
__global__ void __launch_bounds__(C::NT)
simt_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ shift, const T* __restrict__ w,
            const float* __restrict__ bias, const T* __restrict__ res,
            T* __restrict__ y, float* __restrict__ ysum,
            float* __restrict__ ysumsq, int M, int K, int N, int relu) {
  typedef ft::SimtOperand<T, C::BM, C::BK, C::NT, true, true, VEC> OA;
  __shared__ __align__(16) float As[2 * C::BK * C::BM];
  __shared__ __align__(16) float Bs[2 * C::BK * C::BN];
  __shared__ float colsum[C::BN], colsq[C::BN];
  const int tid = threadIdx.x;
  const int ty = tid / C::NTX, tx = tid % C::NTX;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  for (int i = tid; i < C::BN; i += C::NT) colsum[i] = colsq[i] = 0.f;

  __shared__ __align__(16) float tab[OA::TAB];
  OA a(x, K, M, K, scale, shift, relu, tab);
  ft::SimtOperand<T, C::BN, C::BK, C::NT, true, false, VEC> b(
      w, K, N, K, nullptr, nullptr, 0, nullptr);
  float acc[C::TM][C::TN];
  ft::simt_mainloop<C>(a, b, m0, n0, 0, K, As, Bs, acc);

  float ps[C::TN], pq[C::TN];
#pragma unroll
  for (int j = 0; j < C::TN; ++j) ps[j] = pq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gm = m0 + ft::simt_row<C>(i, ty);
    if (gm >= M) continue;
#pragma unroll
    for (int jq = 0; jq < C::TN / 4; ++jq) {
      const int gn = n0 + ft::simt_col<C>(4 * jq, tx);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * jq + e];
      if constexpr (VEC) static_assert(sizeof(T) == 4, "f32 only");
      if (VEC && gn + 3 < N) {
        if (bias) {
          const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + gn));
          v[0] += bb.x, v[1] += bb.y, v[2] += bb.z, v[3] += bb.w;
        }
        if (res) {
          float r[4];
          ft::load4<T>(res + (size_t)gm * N + gn, r);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += r[e];
        }
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = to_f32(from_f32<T>(v[e]));
        *reinterpret_cast<float4*>(y + (size_t)gm * N + gn) =
            make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ps[4 * jq + e] += o[e];
          pq[4 * jq + e] += o[e] * o[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gn + e >= N) continue;
          float t = v[e];
          if (bias) t += bias[gn + e];
          if (res) t += to_f32(res[(size_t)gm * N + gn + e]);
          const T out = from_f32<T>(t);
          y[(size_t)gm * N + gn + e] = out;
          const float s = to_f32(out);  // statistics of the stored value
          ps[4 * jq + e] += s;
          pq[4 * jq + e] += s * s;
        }
      }
    }
  }
  ft::simt_col_add<C>(ps, colsum, tx);
  ft::simt_col_add<C>(pq, colsq, tx);
  __syncthreads();
  for (int i = tid; i < C::BN; i += C::NT) {
    if (n0 + i < N) {
      atomicAdd(&ysum[n0 + i], colsum[i]);
      atomicAdd(&ysumsq[n0 + i], colsq[i]);
    }
  }
}

template <class C>
struct MmaFwd {
  // x [m][k], through the prologue; W [n][k]
  typedef ft::MmaOperand<C::BM, C::NT, true, true> OA;
  typedef ft::MmaOperand<C::BN, C::NT, true, false> OB;
  typedef ft::MmaSmem<OA, OB, 2 * C::BN> Smem;           // + column sums
};

template <class C>
__global__ void __launch_bounds__(C::NT)
mma_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ shift, const bf16* __restrict__ w,
           const float* __restrict__ bias, const bf16* __restrict__ res,
           bf16* __restrict__ y, float* __restrict__ ysum,
           float* __restrict__ ysumsq, int M, int K, int N, int relu) {
  typedef typename MmaFwd<C>::OA OA;
  typedef typename MmaFwd<C>::OB OB;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename MmaFwd<C>::Smem sm(smem);
  float* colsum = sm.extra;
  float* colsq = sm.extra + C::BN;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  for (int i = tid; i < C::BN; i += C::NT) colsum[i] = colsq[i] = 0.f;

  OA a(x, K, M, K, scale, shift, relu, sm.tab_a);
  OB b(w, K, N, K, nullptr, nullptr, 0, sm.tab_b);
  float acc[C::MT][C::NT8][4];
  ft::mma_mainloop<C, OA, OB, true, true>(a, b, m0, n0, 0, K, sm, acc);

  float ps[C::NT8][2], pq[C::NT8][2];
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt)
    ps[nt][0] = ps[nt][1] = pq[nt][0] = pq[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // row g, row g + 8
        const int gm = m0 + ft::mma_row<C>(mt, 2 * hr);
        const int gn = n0 + ft::mma_col<C>(nt, 0);  // even; N % 8 == 0
        if (gm >= M || gn >= N) continue;
        float v0 = acc[mt][nt][2 * hr], v1 = acc[mt][nt][2 * hr + 1];
        if (bias) {
          v0 += bias[gn];
          v1 += bias[gn + 1];
        }
        const size_t at = (size_t)gm * N + gn;
        if (res) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + at));
          v0 += r.x;
          v1 += r.y;
        }
        const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + at) = out;
        const float2 s = __bfloat1622float2(out);
        ps[nt][0] += s.x;
        ps[nt][1] += s.y;
        pq[nt][0] += s.x * s.x;
        pq[nt][1] += s.y * s.y;
      }
  __syncthreads();  // every column sum was zeroed
  ft::mma_col_add<C>(ps, colsum);
  ft::mma_col_add<C>(pq, colsq);
  __syncthreads();
  for (int i = tid; i < C::BN; i += C::NT) {
    if (n0 + i < N) {
      atomicAdd(&ysum[n0 + i], colsum[i]);
      atomicAdd(&ysumsq[n0 + i], colsq[i]);
    }
  }
}

// wgmma: a BM x BN y tile, a warpgroup per 64 rows, 64 deep stages.
// W arrives by cp.async into 128-byte-swizzled rows and is read by
// descriptor; x arrives by cp.async into padded rows, and each thread
// builds its A fragments from them through the prologue, so every x
// element is cooked once per block.  The fragments of stage s + 1 are
// built while the products of stage s run (two register sets).  A ring
// of S stages, one barrier a stage: a slot is refilled only after every
// warpgroup waited for the products that read it.
template <int BM_, int BN_, int S_>
struct WgCfg {
  static constexpr int BM = BM_, BN = BN_, BK = 64, S = S_, NT = 2 * BM;
  static constexpr int XLD = BK + 8;            // x row: conflict-free reads
  static constexpr int W_BYTES = BN * BK * 2;   // a stage of W (1024-B rows)
  static constexpr int X_BYTES = BM * XLD * 2;  // a stage of x
  static constexpr int T_FLOATS = 2 * BK;       // a stage's scale, shift
  static constexpr int BYTES = 1024 + S * (W_BYTES + X_BYTES + T_FLOATS * 4) +
                               2 * BN * 4;  // + alignment slack, column sums
  static constexpr int MIN_BLOCKS = 2 * BYTES <= 227 * 1024 ? 2 : 1;
  static_assert(S >= 3, "stage s + 1 lands while stage s multiplies");
  static_assert(BM % 64 == 0 && (BM * BK / 8) % NT == 0 &&
                    (BN * BK / 8) % NT == 0 && BN % 64 == 0,
                "whole 16-byte chunks a thread; 128-byte W rows");
};
// kernel A's training-batch tile: three stages keep two blocks (four
// warpgroups) on an SM, so one warpgroup's products run while another
// builds fragments; wider tiles or deeper rings leave one block an SM
typedef WgCfg<128, 128, 3> Wg;

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
wg_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ shift, const bf16* __restrict__ w,
          const float* __restrict__ bias, const bf16* __restrict__ res,
          bf16* __restrict__ y, float* __restrict__ ysum,
          float* __restrict__ ysumsq, int M, int K, int N, int relu) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, S = C::S, NT = C::NT;
  constexpr int XLD = C::XLD, KS = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wring = base;
  bf16* xring = reinterpret_cast<bf16*>(base + S * C::W_BYTES);
  float* tring =
      reinterpret_cast<float*>(base + S * (C::W_BYTES + C::X_BYTES));
  float* colsum = tring + S * C::T_FLOATS;
  float* colsq = colsum + BN;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, wq = (tid >> 5) & 3;  // warpgroup, its warp
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < BN; i += NT) colsum[i] = colsq[i] = 0.f;
  const int nst = (K + BK - 1) / BK;

  // stage t into slot t % S: W, x and the prologue's slice as 16-byte
  // chunks, zero-filled out of bounds (padded k reads x = 0 and scale =
  // shift = 0, so its a is 0; padded rows of x give rows never stored)
  auto issue = [&](int t) {
    const int k0 = t * BK, slot = t % S;
    unsigned char* ws = wring + slot * C::W_BYTES;
    bf16* xs = xring + slot * BM * XLD;
#pragma unroll
    for (int j = 0; j < BN * BK / 8 / NT; ++j) {
      const int c = tid + j * NT, r = c >> 3, ch = c & 7, gk = k0 + ch * 8;
      const bool ok = n0 + r < N && gk < K;
      ft::cp_async16(ws + ft::sw128(r, ch),
                     ok ? w + (size_t)(n0 + r) * K + gk : w, ok);
    }
#pragma unroll
    for (int j = 0; j < BM * BK / 8 / NT; ++j) {
      const int c = tid + j * NT, r = c >> 3, ch = c & 7, gk = k0 + ch * 8;
      const bool ok = m0 + r < M && gk < K;
      ft::cp_async16(xs + r * XLD + ch * 8,
                     ok ? x + (size_t)(m0 + r) * K + gk : x, ok);
    }
    if (tid < C::T_FLOATS / 4) {
      const int h = tid / (BK / 4), gk = k0 + (tid % (BK / 4)) * 4;
      const bool ok = gk < K;
      ft::cp_async16(tring + slot * C::T_FLOATS + tid * 4,
                     ok ? (h ? shift : scale) + gk : scale, ok);
    }
  };

  // A fragments of the stage in slot `slot`, k16 step ks: a[ks][2h + r]
  // holds rows row + 8r, columns ks * 16 + 8h + 2q and + 1
  const int row = wgi * 64 + wq * 16 + g;  // this thread's first A row
  auto build = [&](uint32_t (&a)[KS][4], int slot) {
    const bf16* xs = xring + slot * BM * XLD + row * XLD;
    const float* ts = tring + slot * C::T_FLOATS;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = ks * 16 + h * 8 + 2 * q;
        const float2 sc = *reinterpret_cast<const float2*>(ts + kk);
        const float2 sh = *reinterpret_cast<const float2*>(ts + BK + kk);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + r * 8 * XLD + kk));
          const float u0 = ft::affine(xv.x, sc.x, sh.x);
          const float u1 = ft::affine(xv.y, sc.y, sh.y);
          const __nv_bfloat162 pk =
              relu ? ft::pack_relu(u0, u1) : __floats2bfloat162_rn(u0, u1);
          a[ks][2 * h + r] = *reinterpret_cast<const uint32_t*>(&pk);
        }
      }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a0[KS][4], a1[KS][4];
  // stage s: its products from `cur` while stage s + 1 lands and is
  // built into `nxt`
  auto step = [&](uint32_t (&cur)[KS][4], uint32_t (&nxt)[KS][4], int s) {
    const uint64_t desc =
        ft::wg_desc_sw128(ft::smem_addr(wring + (s % S) * C::W_BYTES));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) ft::wg_pin(acc[i]);
    ft::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ft::wgmma_m64k16<BN>(acc, cur[ks], desc + 2 * ks);
    ft::wg_commit();
    ft::cp_async_wait_group<S - 3>();  // stage s + 1 has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the slot of stage s - 1, whose products every warpgroup waited for
    if (s + S - 1 < nst) issue(s + S - 1);
    ft::cp_async_commit();
    if (s + 1 < nst) build(nxt, (s + 1) % S);
    ft::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) ft::wg_pin(acc[i]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) ft::wg_pin(cur[ks][e]);
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nst) issue(t);
    ft::cp_async_commit();
  }
  ft::cp_async_wait_group<S - 2>();  // stage 0 has landed
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  build(a0, 0);
  for (int s = 0; s < nst; s += 2) {
    step(a0, a1, s);
    if (s + 1 < nst) step(a1, a0, s + 1);
  }
  ft::cp_async_wait_all();

  // epilogue: acc[4j + 2hr + e] is row m0 + row + 8hr, column n0 + 8j +
  // 2q + e.  Column sums of each 8-column block as it is stored: over the
  // warp's 8 row groups by shuffles, one shared atomic per warp and column
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float ps[2] = {0.f, 0.f}, pq[2] = {0.f, 0.f};
    const int gn = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gm = m0 + row + 8 * hr;
      if (gm >= M || gn >= N) continue;  // N % 8 == 0: gn + 1 < N too
      float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      if (bias) {
        v0 += bias[gn];
        v1 += bias[gn + 1];
      }
      const size_t at = (size_t)gm * N + gn;
      if (res) {
        const float2 rv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + at));
        v0 += rv.x;
        v1 += rv.y;
      }
      const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(y + at) = out;
      const float2 sv = __bfloat1622float2(out);
      ps[0] += sv.x;
      ps[1] += sv.y;
      pq[0] += sv.x * sv.x;
      pq[1] += sv.y * sv.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ps[e] += __shfl_xor_sync(0xffffffffu, ps[e], o);
        pq[e] += __shfl_xor_sync(0xffffffffu, pq[e], o);
      }
      if (g == 0) {
        atomicAdd(&colsum[8 * j + 2 * q + e], ps[e]);
        atomicAdd(&colsq[8 * j + 2 * q + e], pq[e]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BN; i += NT) {
    if (n0 + i < N) {
      atomicAdd(&ysum[n0 + i], colsum[i]);
      atomicAdd(&ysumsq[n0 + i], colsq[i]);
    }
  }
}

struct Args {
  const void* x;
  const float* scale;
  const float* shift;
  const void* w;
  const float* bias;
  const void* res;
  void* y;
  float* ysum;
  float* ysumsq;
  int M, K, N, relu;
};

template <typename T, int MT, bool VEC>
void launch_decode(const Args& a, cudaStream_t s) {
  decode_kernel<T, MT, VEC><<<(a.N + DEC_WARPS - 1) / DEC_WARPS,
                              DEC_WARPS * 32, 0, s>>>(
      static_cast<const T*>(a.x), a.scale, a.shift,
      static_cast<const T*>(a.w), a.bias, static_cast<const T*>(a.res),
      static_cast<T*>(a.y), a.ysum, a.ysumsq, a.M, a.K, a.N, a.relu);
}

template <typename T, bool VEC>
cudaError_t decode(const Args& a, cudaStream_t s) {
  if (a.M <= 4)
    launch_decode<T, 4, VEC>(a, s);
  else if (a.M <= 8)
    launch_decode<T, 8, VEC>(a, s);
  else if (a.M <= 16)
    launch_decode<T, 16, VEC>(a, s);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <class C>
dim3 tiles(const Args& a) {
  return dim3((a.N + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM);
}

template <class C, typename T, bool VEC>
cudaError_t simt(const Args& a, cudaStream_t s) {
  const dim3 g = tiles<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  simt_kernel<C, T, VEC><<<g, C::NT, 0, s>>>(
      static_cast<const T*>(a.x), a.scale, a.shift,
      static_cast<const T*>(a.w), a.bias, static_cast<const T*>(a.res),
      static_cast<T*>(a.y), a.ysum, a.ysumsq, a.M, a.K, a.N, a.relu);
  return cudaSuccess;
}

template <class C>
cudaError_t mma(const Args& a, cudaStream_t s) {
  const dim3 g = tiles<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = MmaFwd<C>::Smem::BYTES;
  static const cudaError_t attr = ft::allow_smem(mma_kernel<C>, bytes);
  if (attr != cudaSuccess) return attr;
  mma_kernel<C><<<g, C::NT, bytes, s>>>(
      static_cast<const bf16*>(a.x), a.scale, a.shift,
      static_cast<const bf16*>(a.w), a.bias, static_cast<const bf16*>(a.res),
      static_cast<bf16*>(a.y), a.ysum, a.ysumsq, a.M, a.K, a.N, a.relu);
  return cudaSuccess;
}

template <class C>
cudaError_t wgmma(const Args& a, cudaStream_t s) {
  const dim3 g((a.N + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM);
  if (g.y > 65535) return cudaErrorInvalidValue;
  static const cudaError_t attr = ft::allow_smem(wg_kernel<C>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  wg_kernel<C><<<g, C::NT, C::BYTES, s>>>(
      static_cast<const bf16*>(a.x), a.scale, a.shift,
      static_cast<const bf16*>(a.w), a.bias, static_cast<const bf16*>(a.res),
      static_cast<bf16*>(a.y), a.ysum, a.ysumsq, a.M, a.K, a.N, a.relu);
  return cudaSuccess;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the vector variants' preconditions (ops/fused_kernel.py `_plan` holds
// the same; refusing here turns a planning slip into an error, not a
// misaligned load)
bool vec_ok(const Args& a, int width, int bytes) {
  return a.K % width == 0 && a.N % width == 0 && aligned(a.x, bytes) &&
         aligned(a.w, bytes) && aligned(a.res, bytes) && aligned(a.y, bytes) &&
         aligned(a.scale, 16) && aligned(a.shift, 16) && aligned(a.bias, 16);
}

template <typename T>
cudaError_t dispatch(const Args& a, int variant, cudaStream_t s) {
  const bool f32 = sizeof(T) == 4;
  switch (variant) {
    case V_DECODE:
      if (a.K % (16 / (int)sizeof(T)) != 0 || !aligned(a.x, 16) ||
          !aligned(a.w, 16))
        return cudaErrorInvalidValue;
      return decode<T, true>(a, s);
    case V_DECODE_S:
      return decode<T, false>(a, s);
    case V_SIMT128_S:
      return simt<ft::Simt128, T, false>(a, s);
    case V_SIMT64_S:
      return simt<ft::Simt64, T, false>(a, s);
    case V_SIMT32_S:
      return simt<ft::Simt32, T, false>(a, s);
    default:
      break;
  }
  if (f32) {
    if (!vec_ok(a, 4, 16)) return cudaErrorInvalidValue;
    switch (variant) {
      case V_SIMT128:
        return simt<ft::Simt128, float, true>(a, s);
      case V_SIMT64:
        return simt<ft::Simt64, float, true>(a, s);
      case V_SIMT32:
        return simt<ft::Simt32, float, true>(a, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (!vec_ok(a, 8, 16)) return cudaErrorInvalidValue;
  switch (variant) {
    case V_MMA64:
      return mma<ft::Mma64>(a, s);
    case V_WGMMA:
      return wgmma<Wg>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias and residual may be null.
// ysum / ysumsq must be zeroed by the caller.  variant: a code of
// ops/fused_kernel.py VARIANTS.  Returns the CUDA error of the launch
// (0 = cudaSuccess).
int fused_fwd(int dtype, const void* x, const void* scale, const void* shift,
              const void* w, const void* bias, const void* res, void* y,
              void* ysum, void* ysumsq, int M, int K, int N, int relu,
              int variant, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {x, static_cast<const float*>(scale),
                  static_cast<const float*>(shift), w,
                  static_cast<const float*>(bias), res, y,
                  static_cast<float*>(ysum), static_cast<float*>(ysumsq),
                  M, K, N, relu};
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(a, variant, s);
  else if (dtype == 1)
    e = dispatch<bf16>(a, variant, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
