// Kernel F: the backward of kernel A (fused scale/shift(+ReLU) -> matmul),
// dx, dW, dscale and dshift from x and the effective dy.
//
//   u      = x * scale + shift            (recomputed from x, never stored)
//   a      = [relu](u), cast to dy's dtype
//   dz     = dy @ W                       (W in FullyConnected's (N, K))
//   du     = dz * [u > 0]                 (strict, as the TPU kernel)
//   dx     = du * scale,  cast to x's dtype
//   dscale = sum_m du * x,   dshift = sum_m du       (f32)
//   dW     = dy^T @ a                     (N, K), f32
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py `_bwd_kernel`
// (launched by `_bwd_call`).  The wrapper folds the statistics outputs'
// cotangents into dy first and casts dW to w's dtype, as the TPU path's
// custom VJP does.
//
// What bounds it on an H100: 4*M*N*K operations (two products of
// 2*M*N*K) against reading x and dy and writing dx once; at the LM's
// training shapes (M = 16384) it is compute-bound: 67 TFLOP/s on the CUDA
// cores in f32, 989 TFLOP/s on the tensor cores in bf16.
//
// Design.  On the TPU one kernel walked the row blocks in order and
// accumulated dW, dscale and dshift in VMEM across the whole grid.  Blocks
// on Hopper run in no order, so one launch runs two products, each on
// fused_tiles.cuh's engines (the variants ops/fused_kernel.py `_plan`
// picks: f32 simt128 / simt64 / simt32 with 16-byte or scalar loads,
// bf16 mma128 / mma64 on the tensor cores):
//   (i)  dx: dz = dy . W over (rows m, columns k), W read as [n][k]; the
//        epilogue recomputes u from the x tile at (m, k), applies the
//        strict u > 0 mask, writes dx and reduces du * x and du per column
//        in the tile, one atomicAdd per column and tile (the order of
//        those atomics varies, so dscale / dshift vary at about one ulp);
//   (ii) dW: dy^T . a(x) over (rows n, columns k), contraction over M,
//        the prologue applied to x on its way into shared memory.  Where
//        the (N, K) tiles are too few to fill the card (q/k/v: 64 tiles of
//        128 x 128 on 132 SMs) M is split into a fixed number of ranges,
//        each writing an f32 partial into scratch the wrapper allocates,
//        and a second pass sums the partials in a fixed order: dW stays
//        deterministic.
//
// Earlier design: 64 x 64 tiles 16 deep, 4 x 4 outputs a thread,
// scalar loads and scalar shared-memory reads, nothing in flight during
// the multiply-adds, bf16 widened to f32.  Its times stay in PERF.md (ffn1
// f32 13.901 ms, 2.5x its two-matmul yardstick).
#include "fused_tiles.cuh"

namespace {

using ft::bf16;
using ft::to_f32;
using ft::from_f32;

// variant codes, as ops/fused_kernel.py VARIANTS (no decode variant here)
enum {
  V_SIMT128 = 2, V_SIMT128_S, V_SIMT64, V_SIMT64_S, V_SIMT32, V_SIMT32_S,
  V_MMA128, V_MMA64
};

// dx, dscale, dshift epilogue for one element: returns du
template <typename T>
__device__ __forceinline__ float dx_elem(float acc, float xv, float sc,
                                         float sh, int relu, T* out) {
  const float u = ft::affine(xv, sc, sh);
  const float du = (relu && !(u > 0.f)) ? 0.f : acc;
  *out = from_f32<T>(du * sc);
  return du;
}

// (i) dz = dy . W over a (rows m, columns k) tile
template <class C, typename T, bool VEC>
__global__ void __launch_bounds__(C::NT)
simt_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ shift, const T* __restrict__ w,
               T* __restrict__ dx, float* __restrict__ dscale,
               float* __restrict__ dshift, int M, int K, int N, int relu) {
  __shared__ __align__(16) float As[2 * C::BK * C::BM];
  __shared__ __align__(16) float Bs[2 * C::BK * C::BN];
  __shared__ float colx[C::BN], col1[C::BN];
  const int tid = threadIdx.x;
  const int ty = tid / C::NTX, tx = tid % C::NTX;
  const int m0 = blockIdx.y * C::BM, k0 = blockIdx.x * C::BN;
  for (int i = tid; i < C::BN; i += C::NT) colx[i] = col1[i] = 0.f;

  ft::SimtOperand<T, C::BM, C::BK, C::NT, true, false, VEC> a(
      dy, N, M, N, nullptr, nullptr, 0, nullptr);
  ft::SimtOperand<T, C::BN, C::BK, C::NT, false, false, VEC> b(
      w, K, K, N, nullptr, nullptr, 0, nullptr);
  float acc[C::TM][C::TN];
  ft::simt_mainloop<C>(a, b, m0, k0, 0, N, As, Bs, acc);

  float px[C::TN], p1[C::TN];
#pragma unroll
  for (int j = 0; j < C::TN; ++j) px[j] = p1[j] = 0.f;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gm = m0 + ft::simt_row<C>(i, ty);
    if (gm >= M) continue;
#pragma unroll
    for (int jq = 0; jq < C::TN / 4; ++jq) {
      const int gk = k0 + ft::simt_col<C>(4 * jq, tx);
      const size_t at = (size_t)gm * K + gk;
      if constexpr (VEC) static_assert(sizeof(T) == 4, "f32 only");
      if (VEC && gk + 3 < K) {
        float xv[4], sc[4], sh[4], o[4];
        ft::load4<T>(x + at, xv);
        ft::load4<float>(scale + gk, sc);
        ft::load4<float>(shift + gk, sh);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          T ov;
          const float du = dx_elem<T>(acc[i][4 * jq + e], xv[e], sc[e],
                                      sh[e], relu, &ov);
          o[e] = to_f32(ov);
          px[4 * jq + e] += du * xv[e];
          p1[4 * jq + e] += du;
        }
        *reinterpret_cast<float4*>(dx + at) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gk + e >= K) continue;
          const float xv = to_f32(x[at + e]);
          const float du = dx_elem<T>(acc[i][4 * jq + e], xv, scale[gk + e],
                                      shift[gk + e], relu, dx + at + e);
          px[4 * jq + e] += du * xv;
          p1[4 * jq + e] += du;
        }
      }
    }
  }
  ft::simt_col_add<C>(px, colx, tx);
  ft::simt_col_add<C>(p1, col1, tx);
  __syncthreads();
  for (int i = tid; i < C::BN; i += C::NT) {
    if (k0 + i < K) {
      atomicAdd(&dscale[k0 + i], colx[i]);
      atomicAdd(&dshift[k0 + i], col1[i]);
    }
  }
}

// (ii) dW = dy^T . a(x) over a (rows n, columns k) tile, contraction over
// the rows [z * chunk, (z + 1) * chunk) of M; out is dW or the z-th
// partial
template <class C, typename T, bool VEC>
__global__ void __launch_bounds__(C::NT)
simt_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ out,
               int M, int K, int N, int relu, int chunk) {
  __shared__ __align__(16) float As[2 * C::BK * C::BM];
  __shared__ __align__(16) float Bs[2 * C::BK * C::BN];
  const int tid = threadIdx.x;
  const int ty = tid / C::NTX, tx = tid % C::NTX;
  const int n0 = blockIdx.y * C::BM, k0 = blockIdx.x * C::BN;
  const int kbeg = blockIdx.z * chunk, kend = min(M, kbeg + chunk);
  out += (size_t)blockIdx.z * N * K;

  typedef ft::SimtOperand<T, C::BN, C::BK, C::NT, false, true, VEC> OB;
  __shared__ __align__(16) float tab[OB::TAB];
  ft::SimtOperand<T, C::BM, C::BK, C::NT, false, false, VEC> a(
      dy, N, N, kend, nullptr, nullptr, 0, nullptr);
  OB b(x, K, K, kend, scale, shift, relu, tab);
  float acc[C::TM][C::TN];
  ft::simt_mainloop<C>(a, b, n0, k0, kbeg, kend, As, Bs, acc);

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gn = n0 + ft::simt_row<C>(i, ty);
    if (gn >= N) continue;
#pragma unroll
    for (int jq = 0; jq < C::TN / 4; ++jq) {
      const int gk = k0 + ft::simt_col<C>(4 * jq, tx);
      float* o = out + (size_t)gn * K + gk;
      if (VEC && gk + 3 < K) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * jq], acc[i][4 * jq + 1],
                        acc[i][4 * jq + 2], acc[i][4 * jq + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gk + e < K) o[e] = acc[i][4 * jq + e];
      }
    }
  }
}

template <class C>
struct MmaDx {
  // dy [m][n]; W [n][k]
  typedef ft::MmaOperand<C::BM, C::NT, true, false> OA;
  typedef ft::MmaOperand<C::BN, C::NT, false, false> OB;
  typedef ft::MmaSmem<OA, OB, 2 * C::BN> Smem;            // + column sums
};

template <class C>
struct MmaDw {
  // dy [m][n]; x [m][k], through the prologue
  typedef ft::MmaOperand<C::BM, C::NT, false, false> OA;
  typedef ft::MmaOperand<C::BN, C::NT, false, true> OB;
  typedef ft::MmaSmem<OA, OB, 0> Smem;
};

template <class C>
__global__ void __launch_bounds__(C::NT)
mma_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              const float* __restrict__ scale,
              const float* __restrict__ shift, const bf16* __restrict__ w,
              bf16* __restrict__ dx, float* __restrict__ dscale,
              float* __restrict__ dshift, int M, int K, int N, int relu) {
  typedef typename MmaDx<C>::OA OA;
  typedef typename MmaDx<C>::OB OB;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename MmaDx<C>::Smem sm(smem);
  float* colx = sm.extra;
  float* col1 = sm.extra + C::BN;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * C::BM, k0 = blockIdx.x * C::BN;
  for (int i = tid; i < C::BN; i += C::NT) colx[i] = col1[i] = 0.f;

  OA a(dy, N, M, N, nullptr, nullptr, 0, sm.tab_a);
  OB b(w, K, K, N, nullptr, nullptr, 0, sm.tab_b);
  float acc[C::MT][C::NT8][4];
  ft::mma_mainloop<C, OA, OB, true, false>(a, b, m0, k0, 0, N, sm, acc);

  float px[C::NT8][2], p1[C::NT8][2];
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt)
    px[nt][0] = px[nt][1] = p1[nt][0] = p1[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gm = m0 + ft::mma_row<C>(mt, 2 * hr);
        const int gk = k0 + ft::mma_col<C>(nt, 0);  // even; K % 8 == 0
        if (gm >= M || gk >= K) continue;
        const size_t at = (size_t)gm * K + gk;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + at));
        bf16 o0, o1;
        const float du0 = dx_elem<bf16>(acc[mt][nt][2 * hr], xv.x, scale[gk],
                                        shift[gk], relu, &o0);
        const float du1 =
            dx_elem<bf16>(acc[mt][nt][2 * hr + 1], xv.y, scale[gk + 1],
                          shift[gk + 1], relu, &o1);
        __nv_bfloat162 o;
        o.x = o0;
        o.y = o1;
        *reinterpret_cast<__nv_bfloat162*>(dx + at) = o;
        px[nt][0] += du0 * xv.x;
        px[nt][1] += du1 * xv.y;
        p1[nt][0] += du0;
        p1[nt][1] += du1;
      }
  __syncthreads();  // every column sum was zeroed
  ft::mma_col_add<C>(px, colx);
  ft::mma_col_add<C>(p1, col1);
  __syncthreads();
  for (int i = tid; i < C::BN; i += C::NT) {
    if (k0 + i < K) {
      atomicAdd(&dscale[k0 + i], colx[i]);
      atomicAdd(&dshift[k0 + i], col1[i]);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT)
mma_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              const float* __restrict__ scale,
              const float* __restrict__ shift, float* __restrict__ out,
              int M, int K, int N, int relu, int chunk) {
  typedef typename MmaDw<C>::OA OA;
  typedef typename MmaDw<C>::OB OB;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename MmaDw<C>::Smem sm(smem);
  const int n0 = blockIdx.y * C::BM, k0 = blockIdx.x * C::BN;
  const int kbeg = blockIdx.z * chunk, kend = min(M, kbeg + chunk);
  out += (size_t)blockIdx.z * N * K;

  OA a(dy, N, N, kend, nullptr, nullptr, 0, sm.tab_a);
  OB b(x, K, K, kend, scale, shift, relu, sm.tab_b);
  float acc[C::MT][C::NT8][4];
  ft::mma_mainloop<C, OA, OB, false, false>(a, b, n0, k0, kbeg, kend, sm,
                                            acc);
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gn = n0 + ft::mma_row<C>(mt, 2 * hr);
        const int gk = k0 + ft::mma_col<C>(nt, 0);
        if (gn >= N || gk >= K) continue;
        *reinterpret_cast<float2*>(out + (size_t)gn * K + gk) =
            make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
      }
}

// dW = the partials summed in split order (deterministic)
__global__ void dw_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dw, size_t nk,
                              int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nk;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < splits; ++j) s += part[j * nk + i];
    dw[i] = s;
  }
}

struct Args {
  const void* x;
  const void* dy;
  const float* scale;
  const float* shift;
  const void* w;
  void* dx;
  float* dw;  // dW, or the partials when split
  float* dscale;
  float* dshift;
  int M, K, N, relu, splits, chunk;
};

template <class C>
dim3 dx_grid(const Args& a) {
  return dim3((a.K + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM);
}
template <class C>
dim3 dw_grid(const Args& a) {
  return dim3((a.K + C::BN - 1) / C::BN, (a.N + C::BM - 1) / C::BM,
              a.splits);
}

template <class C, typename T, bool VEC>
cudaError_t simt_dx(const Args& a, cudaStream_t s) {
  const dim3 g = dx_grid<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  simt_dx_kernel<C, T, VEC><<<g, C::NT, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.scale,
      a.shift, static_cast<const T*>(a.w), static_cast<T*>(a.dx), a.dscale,
      a.dshift, a.M, a.K, a.N, a.relu);
  return cudaSuccess;
}

template <class C, typename T, bool VEC>
cudaError_t simt_dw(const Args& a, cudaStream_t s) {
  const dim3 g = dw_grid<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  simt_dw_kernel<C, T, VEC><<<g, C::NT, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.scale,
      a.shift, a.dw, a.M, a.K, a.N, a.relu, a.chunk);
  return cudaSuccess;
}

template <class C>
cudaError_t mma_dx(const Args& a, cudaStream_t s) {
  const dim3 g = dx_grid<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = MmaDx<C>::Smem::BYTES;
  static const cudaError_t attr = ft::allow_smem(mma_dx_kernel<C>, bytes);
  if (attr != cudaSuccess) return attr;
  mma_dx_kernel<C><<<g, C::NT, bytes, s>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.dy), a.scale,
      a.shift, static_cast<const bf16*>(a.w), static_cast<bf16*>(a.dx),
      a.dscale, a.dshift, a.M, a.K, a.N, a.relu);
  return cudaSuccess;
}

template <class C>
cudaError_t mma_dw(const Args& a, cudaStream_t s) {
  const dim3 g = dw_grid<C>(a);
  if (g.y > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = MmaDw<C>::Smem::BYTES;
  static const cudaError_t attr = ft::allow_smem(mma_dw_kernel<C>, bytes);
  if (attr != cudaSuccess) return attr;
  mma_dw_kernel<C><<<g, C::NT, bytes, s>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.dy), a.scale,
      a.shift, a.dw, a.M, a.K, a.N, a.relu, a.chunk);
  return cudaSuccess;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the vector variants' preconditions (ops/fused_kernel.py `_plan` holds
// the same; refusing here turns a planning slip into an error, not a
// misaligned load)
bool vec_ok(const Args& a, int width) {
  return a.K % width == 0 && a.N % width == 0 && aligned(a.x) &&
         aligned(a.dy) && aligned(a.w) && aligned(a.dx) && aligned(a.dw) &&
         aligned(a.scale) && aligned(a.shift);
}

// one product: dx (dw = false) or dW
template <typename T, bool DW>
cudaError_t product(const Args& a, int variant, cudaStream_t s) {
  switch (variant) {
    case V_SIMT128_S:
      return DW ? simt_dw<ft::Simt128, T, false>(a, s)
                : simt_dx<ft::Simt128, T, false>(a, s);
    case V_SIMT64_S:
      return DW ? simt_dw<ft::Simt64, T, false>(a, s)
                : simt_dx<ft::Simt64, T, false>(a, s);
    case V_SIMT32_S:
      return DW ? simt_dw<ft::Simt32, T, false>(a, s)
                : simt_dx<ft::Simt32, T, false>(a, s);
    default:
      break;
  }
  if constexpr (sizeof(T) == 4) {
    if (!vec_ok(a, 4)) return cudaErrorInvalidValue;
    switch (variant) {
      case V_SIMT128:
        return DW ? simt_dw<ft::Simt128, T, true>(a, s)
                  : simt_dx<ft::Simt128, T, true>(a, s);
      case V_SIMT64:
        return DW ? simt_dw<ft::Simt64, T, true>(a, s)
                  : simt_dx<ft::Simt64, T, true>(a, s);
      case V_SIMT32:
        return DW ? simt_dw<ft::Simt32, T, true>(a, s)
                  : simt_dx<ft::Simt32, T, true>(a, s);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    if (!vec_ok(a, 8)) return cudaErrorInvalidValue;
    switch (variant) {
      case V_MMA128:
        return DW ? mma_dw<ft::Mma128>(a, s) : mma_dx<ft::Mma128>(a, s);
      case V_MMA64:
        return DW ? mma_dw<ft::Mma64>(a, s) : mma_dx<ft::Mma64>(a, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t run(Args a, int variant_dx, int variant_dw, float* dw,
                float* dw_part, cudaStream_t s) {
  cudaError_t e = product<T, false>(a, variant_dx, s);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.dw = a.splits > 1 ? dw_part : dw;
  e = product<T, true>(a, variant_dw, s);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const size_t nk = (size_t)a.N * a.K;
  const int blocks = (int)((nk + 255) / 256 < 4096 ? (nk + 255) / 256 : 4096);
  dw_sum_kernel<<<blocks, 256, 0, s>>>(dw_part, dw, nk, a.splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dy, w, dx).  x (M, K), dy (M, N),
// w (N, K), dx (M, K); dw (N, K) f32; dscale / dshift (K,) f32, zeroed by
// the caller.  variant_dx / variant_dw: codes of ops/fused_kernel.py
// VARIANTS; splits: the ranges M is split into for dW, and dw_part
// (splits, N, K) f32 scratch when splits > 1.  Returns the CUDA error of
// the launches (0 = cudaSuccess).
int fused_bwd(int dtype, const void* x, const void* dy, const void* scale,
              const void* shift, const void* w, void* dx, void* dw,
              void* dscale, void* dshift, int M, int K, int N, int relu,
              int variant_dx, int variant_dw, int splits, void* dw_part,
              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > 64 ||
      (splits > 1 && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // each split's rows a multiple of 32, the deepest stage of any engine
  const int chunk = ((M + splits - 1) / splits + 31) / 32 * 32;
  Args a = {x, dy, static_cast<const float*>(scale),
            static_cast<const float*>(shift), w, dx, static_cast<float*>(dw),
            static_cast<float*>(dscale), static_cast<float*>(dshift),
            M, K, N, relu, splits, chunk};
  float* dwf = static_cast<float*>(dw);
  float* part = static_cast<float*>(dw_part);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(a, variant_dx, variant_dw, dwf, part, s);
  else if (dtype == 1)
    e = run<bf16>(a, variant_dx, variant_dw, dwf, part, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
