// Kernel B1: the multi-tensor optimizer update over persistent slabs, in
// place.
//
//   g = g * rescale;  g = clip > 0 ? clamp(g, -clip, clip) : g
//   sgd:      w' = w - lr * (g + wd * w)
//   sgd-mom:  m' = momentum * m - lr * (g + wd * w);  w' = w + m'
//   adam:     g = g + wd * w;  mean' = b1 * mean + (1 - b1) * g
//             var' = b2 * var + (1 - b2) * g * g
//             w' = w - (lr * mean') / (sqrt(var') + eps)
//   store w' in the master dtype (f32 or bf16), the slots in the master
//   dtype, and (wc) w' in the compute dtype (bf16 or f16)
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_update.py `_kernel`
// (launched by `_bucket_call`).  A slab is (rows, 128) with rows a
// multiple of the plan's block height R (16, 32 or 64: the tuned
// `block_rows` of ops/update_kernel.py): plan block b is elements
// [128 R b, 128 R (b + 1)) and takes lr[b], wd[b] (one parameter's segment
// never shares a block with another's).  The gradient slab is always f32.
//
// Design: one CUDA block of 256 threads per plan block, walking it in
// chunks of 2048 elements (8 a thread), loaded and stored 16 bytes at a
// time (two float4 for f32, one uint4 of 8 bf16 / f16), with f32
// arithmetic in registers.  The block's element count is a launch
// argument (a multiple of 2048), so the block height is a plan choice,
// not a build constant.  No block depends on another, so the grid is the
// block count and nothing is reduced.  Every product, sum, difference,
// square root and quotient rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fsqrt_rn, __fdiv_rn) in the order above: nvcc would
// otherwise contract `a * b + c` into one FMA, and the kernel would no
// longer equal its plain version (torch ops, one rounding per op) bit for
// bit.  The clamp
// is written with comparisons, so a NaN gradient stays NaN as it does in
// torch.clamp.  Casts to bf16 / f16 round to nearest even, as torch's do.
//
// What bounds it on an H100: memory.  SGD-momentum with f32 masters and a
// bf16 copy moves 22 bytes an element (read w, g, m; write w, m, wc) for
// 9 flops; Adam about 30 flops over 28 bytes.  The least time is the
// slab's bytes over 3.35 TB/s.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kChunkElems = 2048;  // (16, 128): one pass of a block
constexpr int kThreads = 256;
constexpr int kPer = 8;            // elements per thread

struct Hyper {
  float rescale, clip, h2, h3, h4;  // h2.. = momentum | b1, b2, eps
};

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(__half* p, const float* v) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// KIND 0 = sgd (NSLOTS 0 or 1), 1 = adam (NSLOTS 2).  TM: master / slot
// storage type; TC: compute-copy type, written only when HAS_WC.
template <int KIND, int NSLOTS, typename TM, typename TC, bool HAS_WC>
__global__ void __launch_bounds__(kThreads)
mtu_kernel(TM* __restrict__ w, const float* __restrict__ g,
           TM* __restrict__ s0, TM* __restrict__ s1, TC* __restrict__ wc,
           const float* __restrict__ lr, const float* __restrict__ wd,
           Hyper hp, int block_elems) {
  const float blr = lr[blockIdx.x];
  const float bwd = wd[blockIdx.x];
  for (int c = 0; c < block_elems; c += kChunkElems) {
    const int64_t base = (int64_t)blockIdx.x * block_elems + c +
                         (int64_t)threadIdx.x * kPer;
    float wv[kPer], gv[kPer], m0[kPer], m1[kPer];
    load8(w + base, wv);
    load8(g + base, gv);
    if (NSLOTS > 0) load8(s0 + base, m0);
    if (NSLOTS > 1) load8(s1 + base, m1);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float gi = __fmul_rn(gv[i], hp.rescale);
      if (hp.clip > 0.f) {
        gi = gi < -hp.clip ? -hp.clip : (gi > hp.clip ? hp.clip : gi);
      }
      if (KIND == 0) {
        const float step = __fmul_rn(blr, __fadd_rn(gi, __fmul_rn(bwd, wv[i])));
        if (NSLOTS == 1) {
          m0[i] = __fsub_rn(__fmul_rn(hp.h2, m0[i]), step);
          wv[i] = __fadd_rn(wv[i], m0[i]);
        } else {
          wv[i] = __fsub_rn(wv[i], step);
        }
      } else {
        gi = __fadd_rn(gi, __fmul_rn(bwd, wv[i]));
        m0[i] = __fadd_rn(__fmul_rn(hp.h2, m0[i]),
                          __fmul_rn(__fsub_rn(1.f, hp.h2), gi));
        m1[i] = __fadd_rn(__fmul_rn(hp.h3, m1[i]),
                          __fmul_rn(__fsub_rn(1.f, hp.h3), __fmul_rn(gi, gi)));
        wv[i] = __fsub_rn(wv[i],
                          __fdiv_rn(__fmul_rn(blr, m0[i]),
                                    __fadd_rn(__fsqrt_rn(m1[i]), hp.h4)));
      }
    }
    store8(w + base, wv);
    if (NSLOTS > 0) store8(s0 + base, m0);
    if (NSLOTS > 1) store8(s1 + base, m1);
    if (HAS_WC) store8(wc + base, wv);
  }
}

template <int KIND, int NSLOTS, typename TM>
int launch(int wc_code, void* w, const float* g, void* s0, void* s1,
           void* wc, const float* lr, const float* wd, int nblocks,
           int block_elems, Hyper hp, cudaStream_t stream) {
  TM* wm = static_cast<TM*>(w);
  TM* m0 = static_cast<TM*>(s0);
  TM* m1 = static_cast<TM*>(s1);
  switch (wc_code) {
    case 0:
      mtu_kernel<KIND, NSLOTS, TM, float, false>
          <<<nblocks, kThreads, 0, stream>>>(wm, g, m0, m1, nullptr, lr,
                                             wd, hp, block_elems);
      break;
    case 1:
      mtu_kernel<KIND, NSLOTS, TM, __nv_bfloat16, true>
          <<<nblocks, kThreads, 0, stream>>>(
              wm, g, m0, m1, static_cast<__nv_bfloat16*>(wc), lr, wd, hp,
              block_elems);
      break;
    case 2:
      mtu_kernel<KIND, NSLOTS, TM, __half, true>
          <<<nblocks, kThreads, 0, stream>>>(
              wm, g, m0, m1, static_cast<__half*>(wc), lr, wd, hp,
              block_elems);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TM>
int dispatch(int kind, int nslots, int wc_code, void* w, const float* g,
             void* s0, void* s1, void* wc, const float* lr, const float* wd,
             int nblocks, int block_elems, Hyper hp, cudaStream_t stream) {
  if (kind == 0 && nslots == 0)
    return launch<0, 0, TM>(wc_code, w, g, s0, s1, wc, lr, wd, nblocks,
                            block_elems, hp, stream);
  if (kind == 0 && nslots == 1)
    return launch<0, 1, TM>(wc_code, w, g, s0, s1, wc, lr, wd, nblocks,
                            block_elems, hp, stream);
  if (kind == 1 && nslots == 2)
    return launch<1, 2, TM>(wc_code, w, g, s0, s1, wc, lr, wd, nblocks,
                            block_elems, hp, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// kind: 0 = sgd, 1 = adam; master: 0 = float32, 1 = bfloat16; wc_code:
// 0 = no compute copy, 1 = bfloat16, 2 = float16.  g, lr and wd are f32;
// s0 / s1 (slots, master dtype) may be null when nslots says so.
// block_elems: elements of a plan block (128 x its block height, a
// multiple of 2048); lr / wd hold one value a block.  h2..h4 are momentum,
// or b1, b2, eps.  Returns the CUDA error of the launch (0 = cudaSuccess).
int multi_tensor_update(int kind, int nslots, int master, int wc_code,
                        void* w, const void* g, void* s0, void* s1, void* wc,
                        const void* lr, const void* wd, int nblocks,
                        int block_elems, float rescale, float clip, float h2,
                        float h3, float h4, void* stream) {
  if (nblocks <= 0 || block_elems <= 0 || block_elems % kChunkElems != 0)
    return (int)cudaErrorInvalidValue;
  if ((nslots > 0 && s0 == nullptr) || (nslots > 1 && s1 == nullptr) ||
      (wc_code != 0 && wc == nullptr))
    return (int)cudaErrorInvalidValue;
  const Hyper hp{rescale, clip, h2, h3, h4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(lr);
  const float* wf = static_cast<const float*>(wd);
  if (master == 0)
    return dispatch<float>(kind, nslots, wc_code, w, gf, s0, s1, wc, lf, wf,
                           nblocks, block_elems, hp, s);
  if (master == 1)
    return dispatch<__nv_bfloat16>(kind, nslots, wc_code, w, gf, s0, s1, wc,
                                   lf, wf, nblocks, block_elems, hp, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
