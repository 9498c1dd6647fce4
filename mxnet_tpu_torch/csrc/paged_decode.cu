// Kernel B: paged split-K flash decoding with in-kernel dequantization.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_decode.py `_kernel`
// (launched by `_paged_flash_call`).  Queries (B, tq, H*Dk) attend a
// slot's ring view of the shared page pools: view slot v of slot b lives
// at pool[table[b, v / pt], v % pt].  Query row i of a window whose total
// appended length is `total` sees view slots
//     v < min(total - (tq - 1) + i, C),   C = M * pt
// (the length/wrap mask of pallas_decode.py:211-217).  Grouped-query
// attention: q-head h reads kv-head h / G.  int8 / fp8 pools carry one
// f32 scale per (token, kv-head) and are dequantized as they are loaded;
// fp8 bytes convert through __nv_cvt_fp8_to_halfraw, never through a
// PyTorch up-cast of the pool.
//
// Grid: one block per (split s, query tile, head h, batch b).  The view's
// M pages are cut into S splits (Flash-Decoding); a block walks its
// split's tokens in chunks of CT, looks up each token's page in the
// table itself (there is no scalar prefetch on this card), keeps a
// running (max, sum, acc) in f32 and writes the UNNORMALISED partials.
// Tokens past the tile's live window are never loaded: the walk stops at
// min(split end, largest limit of the tile's rows) — the page skip of
// pallas_decode.py:234.  The cross-split combine is a few torch ops in
// the wrapper (mxnet_tpu_torch/ops/decode_kernel.py), as it is jnp
// outside the pallas_call in the JAX package.
//
// Query rows are tiled (TQ rows a block): a 256-token prefill chunk with
// 256-wide heads needs a 256 KB f32 accumulator, more than a block's
// registers or its 227 KB of shared memory, so the tile axis splits it.
//
// What bounds it on an H100: device-memory bytes of the live K/V pages
// (int8 at serving), read once per q-head group; the score and value
// products are small.  This version is written to be right, not fast:
// products run on CUDA cores from shared memory, one block per (b, h,
// split) leaves the card under-filled at 4 slots x 4 heads, and each
// q-head of a group re-reads its kv-head's pages.  Tensor cores, TMA and
// wider split/group parallelism are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // CT: tokens loaded per step (one per lane)

enum PoolType { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3, kE5M2 = 4 };

template <int PTYPE> __device__ __forceinline__ float load_elem(
    const void* base, size_t idx);
template <> __device__ __forceinline__ float load_elem<kF32>(
    const void* base, size_t idx) {
  return static_cast<const float*>(base)[idx];
}
template <> __device__ __forceinline__ float load_elem<kBF16>(
    const void* base, size_t idx) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx]);
}
template <> __device__ __forceinline__ float load_elem<kI8>(
    const void* base, size_t idx) {
  return static_cast<float>(static_cast<const int8_t*>(base)[idx]);
}
template <> __device__ __forceinline__ float load_elem<kE4M3>(
    const void* base, size_t idx) {
  const __nv_fp8_storage_t b =
      static_cast<const __nv_fp8_storage_t*>(base)[idx];
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}
template <> __device__ __forceinline__ float load_elem<kE5M2>(
    const void* base, size_t idx) {
  const __nv_fp8_storage_t b =
      static_cast<const __nv_fp8_storage_t*>(base)[idx];
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E5M2)));
}

__host__ __device__ inline int smem_floats(int TQ, int Dk, int Dv) {
  // sQ[TQ][Dk] sK[CT][Dk+1] sV[CT][Dv] sAcc[TQ][Dv] sP[TQ][CT] sM, sL[TQ]
  return TQ * Dk + kChunk * (Dk + 1) + kChunk * Dv + TQ * Dv + TQ * kChunk +
         2 * TQ;
}

template <int PTYPE>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lens, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int tq, int H, int Hkv, int Dk, int Dv, int pt, int M,
                    int S, int TQ, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + TQ * Dk;
  float* sV = sK + kChunk * (Dk + 1);
  float* sAcc = sV + kChunk * Dv;
  float* sP = sAcc + TQ * Dv;
  float* sM = sP + TQ * kChunk;
  float* sL = sM + TQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.x % S;
  const int tile = blockIdx.x / S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = tile * TQ;
  const int nq = min(TQ, tq - q0);

  const int C = M * pt;
  const int total = lens[b];
  const int pages_per_split = M / S;
  const int v_begin = s * pages_per_split * pt;
  // largest limit among this tile's rows; no row sees a slot past it
  const int tile_limit = min(total - (tq - 1) + (q0 + nq - 1), C);
  const int v_end = min(v_begin + pages_per_split * pt, tile_limit);

  const int E = H * Dk;
  const size_t krow = (size_t)Hkv * Dk;  // pool row widths (E_kv)
  const size_t vrow = (size_t)Hkv * Dv;
  for (int idx = tid; idx < TQ * Dk; idx += kThreads) {
    const int i = idx / Dk, d = idx % Dk;
    sQ[idx] = (i < nq)
                  ? q[((size_t)b * tq + q0 + i) * E + (size_t)h * Dk + d]
                  : 0.f;
  }
  for (int idx = tid; idx < TQ * Dv; idx += kThreads) sAcc[idx] = 0.f;
  for (int i = tid; i < TQ; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  __syncthreads();

  for (int v0 = v_begin; v0 < v_end; v0 += kChunk) {
    const int n = min(kChunk, v_end - v0);
    // load (and dequantize) the chunk's K and V rows of kv-head kvh
    for (int idx = tid; idx < n * Dk; idx += kThreads) {
      const int j = idx / Dk, d = idx % Dk;
      const int v = v0 + j;
      const size_t row = (size_t)table[(size_t)b * M + v / pt] * pt + v % pt;
      float val = load_elem<PTYPE>(kp, row * krow + (size_t)kvh * Dk + d);
      if (ks) val *= ks[row * Hkv + kvh];
      sK[j * (Dk + 1) + d] = val;
    }
    for (int idx = tid; idx < n * Dv; idx += kThreads) {
      const int j = idx / Dv, d = idx % Dv;
      const int v = v0 + j;
      const size_t row = (size_t)table[(size_t)b * M + v / pt] * pt + v % pt;
      float val = load_elem<PTYPE>(vp, row * vrow + (size_t)kvh * Dv + d);
      if (vs) val *= vs[row * Hkv + kvh];
      sV[j * Dv + d] = val;
    }
    __syncthreads();

    // masked, scaled logits of every (row, token) pair of the chunk
    for (int p = tid; p < TQ * kChunk; p += kThreads) {
      const int i = p / kChunk, j = p % kChunk;
      float sc = -INFINITY;
      if (i < nq && j < n) {
        const int limit = min(total - (tq - 1) + q0 + i, C);
        if (v0 + j < limit) {
          const float* qr = sQ + i * Dk;
          const float* kr = sK + j * (Dk + 1);
          float dot = 0.f;
          for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot * scale;
        }
      }
      sP[p] = sc;
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per token
    for (int i = warp; i < nq; i += kThreads / 32) {
      const float sc = sP[i * kChunk + lane];
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[i];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float pv = (sc == -INFINITY) ? 0.f : expf(sc - m_safe);
      float psum = pv;
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float corr = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_safe);
      sP[i * kChunk + lane] = pv;
      __syncwarp();
      for (int d = lane; d < Dv; d += 32) {
        float a = sAcc[i * Dv + d] * corr;
        for (int j = 0; j < n; ++j)
          a = fmaf(sP[i * kChunk + j], sV[j * Dv + d], a);
        sAcc[i * Dv + d] = a;
      }
      if (lane == 0) {
        sL[i] = sL[i] * corr + psum;
        sM[i] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nq * Dv; idx += kThreads) {
    const int i = idx / Dv, d = idx % Dv;
    const size_t base = (((size_t)b * H + h) * S + s) * tq + q0 + i;
    acc_out[base * Dv + d] = sAcc[i * Dv + d];
  }
  for (int i = tid; i < nq; i += kThreads) {
    const size_t base = (((size_t)b * H + h) * S + s) * tq + q0 + i;
    m_out[base] = sM[i];
    l_out[base] = sL[i];
  }
}

template <int PTYPE>
int launch(const float* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* lens, float* acc,
           float* m, float* l, int B, int tq, int H, int Hkv, int Dk, int Dv,
           int pt, int M, int S, int TQ, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(TQ, Dk, Dv);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<PTYPE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (tq + TQ - 1) / TQ;
  dim3 grid(S * tiles, H, B);
  paged_decode_kernel<PTYPE><<<grid, kThreads, smem, stream>>>(
      q, kp, vp, ks, vs, table, lens, acc, m, l, tq, H, Hkv, Dk, Dv, pt, M, S,
      TQ, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block takes at this tile height.
int paged_decode_smem_bytes(int TQ, int Dk, int Dv) {
  return (int)sizeof(float) * smem_floats(TQ, Dk, Dv);
}

// pool_type: 0 f32, 1 bf16, 2 int8, 3 fp8 e4m3, 4 fp8 e5m2.  kscale /
// vscale are null for unquantized pools.  Writes the split partials
// acc (B, H, S, tq, Dv), m and l (B, H, S, tq).  Returns the CUDA error of
// the launch (0 = cudaSuccess).
int paged_decode(int pool_type, const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* table,
                 const void* lens, void* acc, void* m, void* l, int B, int tq,
                 int H, int Hkv, int Dk, int Dv, int pt, int M, int S, int TQ,
                 float scale, void* stream) {
  if (B <= 0 || tq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Dk <= 0 ||
      Dv <= 0 || pt <= 0 || M <= 0 || S <= 0 || M % S || TQ <= 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lens);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MX_LAUNCH(T)                                                        \
  return launch<T>(qf, kp, vp, ksf, vsf, tb, ln, a, mm, ll, B, tq, H, Hkv, \
                   Dk, Dv, pt, M, S, TQ, scale, st)
  switch (pool_type) {
    case kF32: MX_LAUNCH(kF32);
    case kBF16: MX_LAUNCH(kBF16);
    case kI8: MX_LAUNCH(kI8);
    case kE4M3: MX_LAUNCH(kE4M3);
    case kE5M2: MX_LAUNCH(kE5M2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MX_LAUNCH
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
