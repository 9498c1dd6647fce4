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
// Design.  On the TPU one kernel walked the row blocks in order and
// accumulated dW, dscale and dshift in VMEM across the whole grid.  Blocks
// on Hopper run in no order, so the reduction over M is split into two
// kernels of one launch:
//   (i)  row tiles: a (BM x BN) tile of dz over (rows, K) reduces over N,
//        then the epilogue recomputes u from x, applies the ReLU mask,
//        writes dx and reduces du * x and du per column in shared memory,
//        adding one partial per column and tile with atomicAdd (the order
//        of those atomics varies, so dscale/dshift vary at about one ulp
//        from run to run);
//   (ii) dW tiles: each block owns a (BM x BN) tile of dW over (N, K) and
//        loops over all M rows, recomputing a from x as the x tile enters
//        shared memory, so the activation never reaches device memory,
//        and writes its tile once: dW is deterministic.
// Both are 64 x 64 tiles, 16-deep reduction steps, 4 x 4 outputs per
// thread, masked edges in every dimension.
//
// What bounds it on an H100: 4*M*N*K FLOPs (two products of 2*M*N*K)
// against reading x and dy and writing dx once: at the LM's training
// shapes (M = 16384) it is compute-bound.  This version runs f32 FMAs on
// CUDA cores (67 TFLOP/s peak), bf16 inputs widened: it is written to be
// right, not fast.  Tensor-core products and TMA loads are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BKR = 16, TM = 4, TN = 4;
constexpr int NT = (BM / TM) * (BN / TN);  // 256

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// x * scale + shift rounded after the multiply and after the add, as
// the plain version's two torch ops round it: an FMA would round once,
// and in bf16 the activation's rounding then flips for some elements
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// acc += As^T Bs over one BKR-deep step: As[kk][row], Bs[kk][col]
__device__ __forceinline__ void mac_step(float (&acc)[TM][TN],
                                         const float (&As)[BKR][BM + 1],
                                         const float (&Bs)[BKR][BN + 1],
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BKR; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// (i) dz = dy @ W over a (rows m, cols k) tile; epilogue: dx, dscale, dshift
template <typename T>
__global__ void __launch_bounds__(NT)
fused_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, const T* __restrict__ w,
                    T* __restrict__ dx, float* __restrict__ dscale,
                    float* __restrict__ dshift, int M, int K, int N,
                    int relu) {
  __shared__ float As[BKR][BM + 1];  // dy tile, n-major
  __shared__ float Bs[BKR][BN + 1];  // W tile, n-major
  __shared__ float colx[BN];
  __shared__ float col1[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BKR) {
    // neighbouring threads read neighbouring n of a dy row
    for (int i = tid; i < BM * BKR; i += NT) {
      const int r = i / BKR, c = i % BKR;
      const int gm = m0 + r, gn = n0 + c;
      As[c][r] = (gm < M && gn < N) ? to_f32(dy[(size_t)gm * N + gn]) : 0.f;
    }
    // neighbouring threads read neighbouring k of a W row
    for (int i = tid; i < BN * BKR; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gn = n0 + r, gk = k0 + c;
      Bs[r][c] = (gn < N && gk < K) ? to_f32(w[(size_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
    mac_step(acc, As, Bs, ty, tx);
    __syncthreads();
  }

  for (int i = tid; i < BN; i += NT) colx[i] = col1[i] = 0.f;
  __syncthreads();
  float px[TN], p1[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) px[j] = p1[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gk = k0 + tx * TN + j;
      if (gk >= K) continue;
      const size_t at = (size_t)gm * K + gk;
      const float xv = to_f32(x[at]);
      const float u = affine(xv, scale[gk], shift[gk]);
      const float du = (relu && !(u > 0.f)) ? 0.f : acc[i][j];
      dx[at] = from_f32<T>(du * scale[gk]);
      px[j] += du * xv;
      p1[j] += du;
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    if (k0 + tx * TN + j < K) {
      atomicAdd(&colx[tx * TN + j], px[j]);
      atomicAdd(&col1[tx * TN + j], p1[j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < BN; i += NT) {
    if (k0 + i < K) {
      atomicAdd(&dscale[k0 + i], colx[i]);
      atomicAdd(&dshift[k0 + i], col1[i]);
    }
  }
}

// (ii) dW = dy^T @ a over a (rows n, cols k) tile, looping over all M rows
template <typename T>
__global__ void __launch_bounds__(NT)
fused_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ dw,
                    int M, int K, int N, int relu) {
  __shared__ float As[BKR][BM + 1];  // dy tile, m-major: As[mm][n]
  __shared__ float Bs[BKR][BN + 1];  // activation tile, m-major: Bs[mm][k]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int n0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BKR) {
    for (int i = tid; i < BM * BKR; i += NT) {
      const int r = i / BM, c = i % BM;
      const int gm = m0 + r, gn = n0 + c;
      As[r][c] = (gm < M && gn < N) ? to_f32(dy[(size_t)gm * N + gn]) : 0.f;
    }
    for (int i = tid; i < BN * BKR; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gk = k0 + c;
      float a = 0.f;
      if (gm < M && gk < K) {
        a = affine(to_f32(x[(size_t)gm * K + gk]), scale[gk], shift[gk]);
        if (relu) a = fmaxf(a, 0.f);
        a = to_f32(from_f32<T>(a));  // the activation in dy's dtype
      }
      Bs[r][c] = a;
    }
    __syncthreads();
    mac_step(acc, As, Bs, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gn = n0 + ty * TM + i;
    if (gn >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gk = k0 + tx * TN + j;
      if (gk < K) dw[(size_t)gn * K + gk] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* dy, const float* scale,
                const float* shift, const void* w, void* dx, float* dw,
                float* dscale, float* dshift, int M, int K, int N, int relu,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  dim3 g1((K + BN - 1) / BN, (M + BM - 1) / BM);
  fused_bwd_dx_kernel<T><<<g1, NT, 0, s>>>(
      xt, dyt, scale, shift, static_cast<const T*>(w), static_cast<T*>(dx),
      dscale, dshift, M, K, N, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g2((K + BN - 1) / BN, (N + BM - 1) / BM);
  fused_bwd_dw_kernel<T><<<g2, NT, 0, s>>>(xt, dyt, scale, shift, dw, M, K,
                                           N, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dy, w, dx).  x (M, K), dy (M, N),
// w (N, K), dx (M, K); dw (N, K) f32; dscale / dshift (K,) f32, zeroed by
// the caller.  Returns the CUDA error of the launches (0 = cudaSuccess).
int fused_bwd(int dtype, const void* x, const void* dy, const void* scale,
              const void* shift, const void* w, void* dx, void* dw,
              void* dscale, void* dshift, int M, int K, int N, int relu,
              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + BM - 1) / BM > 65535 ||
      (N + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* dwf = static_cast<float*>(dw);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dshift);
  cudaError_t e;
  if (dtype == 0)
    e = run<float>(x, dy, sc, sh, w, dx, dwf, ds, db, M, K, N, relu, s);
  else if (dtype == 1)
    e = run<__nv_bfloat16>(x, dy, sc, sh, w, dx, dwf, ds, db, M, K, N, relu,
                           s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)e;
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
