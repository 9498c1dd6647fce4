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
// Design: a simple tiled kernel.  A 2-D grid over (N, M) output tiles, a
// loop over K in BK-deep steps.  The scale/shift/ReLU prologue is applied
// to each x element as it enters shared memory, so the activation never
// exists in device memory; bias and residual are added in the epilogue.
// Edges in M, K and N are masked, so any shape is taken.  Column sums go
// through a per-tile reduction in shared memory and then one atomicAdd
// per column and tile into the (N,) f32 outputs: the order of those
// atomics varies from run to run, so ysum/ysumsq are nondeterministic at
// about one ulp.
//
// What bounds it on an H100: at decode (M = serving slots = 4) every
// weight element is used 4 times, so the kernel is bound by reading W
// (K*N elements) from device memory; at a 256-token prefill chunk in f32
// the arithmetic intensity (~2*M*N*K / (4*N*K) = 128 FLOP/byte) sits near
// the ridge of the f32 CUDA-core rate.  This version is written to be
// right, not fast: it uses CUDA-core FMAs only.  Tensor cores (mma/wgmma),
// TMA loads and split-K for small M are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, const T* __restrict__ w,
                 const float* __restrict__ bias, const T* __restrict__ res,
                 T* __restrict__ y, float* __restrict__ ysum,
                 float* __restrict__ ysumsq, int M, int K, int N, int relu) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 1];  // prologue-applied x tile, k-major
  __shared__ float Bs[BK][BN + 1];  // weight tile, k-major
  __shared__ float colsum[BN];
  __shared__ float colsq[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // neighbouring threads read neighbouring k: coalesced along rows
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      float a = 0.f;
      if (gm < M && gk < K) {
        // multiply and add each rounded (no FMA), as the plain version's
        // two torch ops: an FMA flips some bf16 roundings of a
        a = __fadd_rn(__fmul_rn(to_f32(x[(size_t)gm * K + gk]), scale[gk]),
                      shift[gk]);
        if (relu) a = fmaxf(a, 0.f);
        // the matmul operand is the activation cast to x's dtype
        a = to_f32(from_f32<T>(a));
      }
      As[c][r] = a;
    }
    for (int i = tid; i < BN * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gn = n0 + r, gk = k0 + c;
      Bs[c][r] = (gn < N && gk < K) ? to_f32(w[(size_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
    __syncthreads();
  }

  for (int i = tid; i < BN; i += NT) {
    colsum[i] = 0.f;
    colsq[i] = 0.f;
  }
  __syncthreads();

  float ps[TN], pq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ps[j] = pq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      if (res) v += to_f32(res[(size_t)gm * N + gn]);
      const T out = from_f32<T>(v);
      y[(size_t)gm * N + gn] = out;
      const float s = to_f32(out);  // statistics of the stored value
      ps[j] += s;
      pq[j] += s * s;
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    if (n0 + tx * TN + j < N) {
      atomicAdd(&colsum[tx * TN + j], ps[j]);
      atomicAdd(&colsq[tx * TN + j], pq[j]);
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const float* scale, const float* shift,
            const void* w, const float* bias, const void* res, void* y,
            float* ysum, float* ysumsq, int M, int K, int N, int relu,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_fwd_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), scale, shift, static_cast<const T*>(w),
          bias, static_cast<const T*>(res), static_cast<T*>(y), ysum, ysumsq,
          M, K, N, relu);
}

template <typename T>
void dispatch(const void* x, const float* scale, const float* shift,
              const void* w, const float* bias, const void* res, void* y,
              float* ysum, float* ysumsq, int M, int K, int N, int relu,
              cudaStream_t stream) {
  if (M <= 16) {
    // decode: few rows, narrow tiles so N spreads over many blocks
    launch<T, 16, 16, 64, 1, 1>(x, scale, shift, w, bias, res, y, ysum,
                                ysumsq, M, K, N, relu, stream);
  } else {
    launch<T, 64, 64, 16, 4, 4>(x, scale, shift, w, bias, res, y, ysum,
                                ysumsq, M, K, N, relu, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  bias and residual may be null.
// ysum / ysumsq must be zeroed by the caller.  Returns the CUDA error of
// the launch (0 = cudaSuccess).
int fused_fwd(int dtype, const void* x, const void* scale, const void* shift,
              const void* w, const void* bias, const void* res, void* y,
              void* ysum, void* ysumsq, int M, int K, int N, int relu,
              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* b = static_cast<const float*>(bias);
  float* s1 = static_cast<float*>(ysum);
  float* s2 = static_cast<float*>(ysumsq);
  if (dtype == 0) {
    dispatch<float>(x, sc, sh, w, b, res, y, s1, s2, M, K, N, relu, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(x, sc, sh, w, b, res, y, s1, s2, M, K, N, relu,
                            s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
