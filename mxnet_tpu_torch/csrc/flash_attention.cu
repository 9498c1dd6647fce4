// Kernels C, D and E: causal flash attention for training, forward and
// backward, over head-folded (B*H, T, hd) tensors.
//
//   C  o = softmax(q k^T * scale [causal]) v,  lse = m + log(l) per row
//   D  dq = sum_k ds k,        ds = p (dp - delta) scale
//   E  dk = sum_q ds^T q,  dv = sum_q p^T do   (summed over the G q-heads
//      of a kv group)
//   p = exp(s - lse), dp = do v^T, delta = rowsum(do * o)  (delta comes in
//   from the wrapper, computed in f32 as the TPU path computes it)
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_attention.py: C is
// `_kernel` (launched by `_fwd_call`), D is `_bwd_dq_kernel`, E is both
// `_bwd_dkv_kernel` and `_bwd_dkv_kernel_grouped` (launched by
// `_bwd_call`): one kernel with a G argument covers the MHA and the
// grouped-query call.  q-row b reads kv-row b / G, as the TPU index maps do.
//
// Numerics follow the TPU kernels: s = (q.k) * scale in f32, the scale
// product rounded on its own (no FMA into the exponent; bf16 inputs
// are widened exactly, products accumulate in f32); rows with every key
// masked keep m = -inf and normalise through m_safe/corr; P.V in f32 even
// for bf16 inputs; a zero denominator reads as 1; D rounds ds to k's
// dtype before ds.k, E rounds p to do's dtype and ds to q's dtype.
//
// Design.  The TPU carried the online-softmax state (m, l, acc) and the
// dq/dk/dv accumulators in VMEM scratch across a sequential grid axis.
// Here that axis is a loop inside the block: one block of 256 threads
// per (folded row, 64-row tile) walks the 64-row tiles of the other side,
// and the accumulators stay in registers until the single write.  Thread
// (ty, tx) of a 16 x 16 grid owns tile rows 4*ty .. 4*ty+3 and columns
// tx + 16*j, so the 16 threads of a row are one half-warp and row maxima
// and sums reduce with shuffles.  Tiles live in shared memory as f32 with
// rows padded to hd+1 floats (conflict-free column walks); C and D load K
// and V through one buffer in turn.  Causal tiles wholly above the
// diagonal are skipped (the TPU's pl.when), and ragged T is masked, so
// any T is taken.  hd is 64 or 128.  No atomics: each block owns its
// output tile, so results are deterministic.
//
// What bounds it on an H100: at T = 2048, hd = 128 the work is
// T^2*hd*BH/2 multiply-adds per product; the kernel is compute-bound
// (f32 FMAs on CUDA cores, 67 TFLOP/s peak; bf16 inputs are widened, so
// the tensor cores' 989 TFLOP/s stay unused).  This version is written to
// be right: mma/wgmma products, TMA loads and a deeper pipeline are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BKT = 64;   // key rows per tile
constexpr int NT = 256;   // threads per block (16 x 16)
constexpr int TR = 4;     // tile rows per thread
constexpr int TC = 4;     // tile columns per thread (64 / 16)
constexpr int PLD = 65;   // padded row length of the 64 x 64 P / dS tiles

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

// v rounded through T (the TPU kernels' astype before a product)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [row0, row0 + 64) of a (T, HD) slab into a padded f32 tile; rows
// past T read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int Tn) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    const int g = row0 + r;
    dst[r * LD + c] = g < Tn ? to_f32(src[(size_t)g * HD + c]) : 0.f;
  }
}

// acc[i][j] += sum_d A[arow(i)][d] * B[brow(j)][d] over padded tiles:
// A rows 4*ty + i (broadcast within a half-warp), B rows tx + 16*j
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[TR][TC], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[TR], bv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = A[(ty * TR + i) * LD + d];
#pragma unroll
    for (int j = 0; j < TC; ++j) bv[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// C: forward with per-row lse
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tn, int G, float scale,
                 int causal) {
  constexpr int LD = HD + 1;
  constexpr int HC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* KVs = Qs + BQ * LD;    // BKT x LD: K, then V
  float* Ps = KVs + BKT * LD;   // BQ x PLD

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)b * Tn * HD;
  const size_t kvoff = (size_t)(b / G) * Tn * HD;

  load_tile<T, HD>(Qs, q + qoff, q0, Tn);

  float m[TR], l[TR], acc[TR][HC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Tn + BKT - 1) / BKT;
  // causal: key tiles wholly above the diagonal see no query of this tile
  const int kt_end = causal ? min(nkt, (q0 + BQ - 1) / BKT + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();  // the last tile's P.V readers are done with KVs / Ps
    load_tile<T, HD>(KVs, k + kvoff, k0, Tn);
    __syncthreads();
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    tile_dot<HD>(s, Qs, KVs, ty, tx);

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty * TR + i;
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);  // rounded, as (q.k) * scale
        if (kj >= Tn || (causal && kj > qi)) x = -INFINITY;
        s[i][j] = x;
        bm = fmaxf(bm, x);
      }
      bm = row_max(bm);
      const float m_new = fmaxf(m[i], bm);
      // rows with every key masked so far keep m = -inf
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        Ps[(ty * TR + i) * PLD + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // K is read, P is written
    load_tile<T, HD>(KVs, v + kvoff, k0, Tn);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BKT; ++kk) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty * TR + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const float vv = KVs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty * TR + i;
    if (qi >= Tn) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < HC; ++c)
      o[qoff + (size_t)qi * HD + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
    if (tx == 0)
      lse[(size_t)b * Tn + qi] = (m[i] == -INFINITY ? 0.f : m[i]) + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// D: dq
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tn, int G, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int HC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* KVs = dOs + BQ * LD;   // BKT x LD: V, then K
  float* dSs = KVs + BKT * LD;  // BQ x PLD

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t qoff = (size_t)b * Tn * HD;
  const size_t kvoff = (size_t)(b / G) * Tn * HD;

  load_tile<T, HD>(Qs, q + qoff, q0, Tn);
  load_tile<T, HD>(dOs, dout + qoff, q0, Tn);
  float lr[TR], dr[TR], acc[TR][HC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty * TR + i;
    lr[i] = qi < Tn ? lse[(size_t)b * Tn + qi] : 0.f;
    dr[i] = qi < Tn ? delta[(size_t)b * Tn + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Tn + BKT - 1) / BKT;
  const int kt_end = causal ? min(nkt, (q0 + BQ - 1) / BKT + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();  // the last tile's dS.K readers are done
    load_tile<T, HD>(KVs, v + kvoff, k0, Tn);
    __syncthreads();
    float dp[TR][TC], s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) dp[i][j] = s[i][j] = 0.f;
    tile_dot<HD>(dp, dOs, KVs, ty, tx);
    __syncthreads();  // V is read
    load_tile<T, HD>(KVs, k + kvoff, k0, Tn);
    __syncthreads();
    tile_dot<HD>(s, Qs, KVs, ty, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qi = q0 + ty * TR + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool masked = kj >= Tn || (causal && kj > qi);
        const float p =
            masked ? 0.f : expf(__fmul_rn(s[i][j], scale) - lr[i]);
        const float ds = p * (dp[i][j] - dr[i]) * scale;
        dSs[(ty * TR + i) * PLD + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BKT; ++kk) {
      float dv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) dv[i] = dSs[(ty * TR + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const float kv = KVs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(dv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty * TR + i;
    if (qi >= Tn) continue;
#pragma unroll
    for (int c = 0; c < HC; ++c)
      dq[qoff + (size_t)qi * HD + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// E: dk, dv over the G q-heads of a kv group
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tn, int G, float scale,
                     int causal) {
  constexpr int LD = HD + 1;
  constexpr int HC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // BKT x LD
  float* Vs = Ks + BKT * LD;    // BKT x LD
  float* Qs = Vs + BKT * LD;    // BQ x LD
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* Ps = dOs + BQ * LD;    // BKT x PLD (key-major)
  float* dSs = Ps + BKT * PLD;  // BKT x PLD
  float* Ls = dSs + BKT * PLD;  // BQ
  float* Ds = Ls + BQ;          // BQ

  // thread (ty, tx) owns key rows 4*ty + i and query columns tx + 16*j
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BKT;
  const size_t kvoff = (size_t)bkv * Tn * HD;
  load_tile<T, HD>(Ks, k + kvoff, k0, Tn);
  load_tile<T, HD>(Vs, v + kvoff, k0, Tn);

  float dka[TR][HC], dva[TR][HC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int nqt = (Tn + BQ - 1) / BQ;
  // causal: query tiles wholly above this key tile see none of it
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int bq = bkv * G + gi;
    const size_t qoff = (size_t)bq * Tn * HD;
    for (int qt = qt_begin; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, HD>(Qs, q + qoff, q0, Tn);
      load_tile<T, HD>(dOs, dout + qoff, q0, Tn);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const int qi = q0 + r;
        Ls[r] = qi < Tn ? lse[(size_t)bq * Tn + qi] : 0.f;
        Ds[r] = qi < Tn ? delta[(size_t)bq * Tn + qi] : 0.f;
      }
      __syncthreads();
      float s[TR][TC], dp[TR][TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dot<HD>(s, Ks, Qs, ty, tx);
      tile_dot<HD>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int kj = k0 + ty * TR + i;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int r = tx + 16 * j;
          const int qi = q0 + r;
          const bool masked = qi >= Tn || kj >= Tn || (causal && kj > qi);
          const float p =
              masked ? 0.f : expf(__fmul_rn(s[i][j], scale) - Ls[r]);
          const float ds = p * (dp[i][j] - Ds[r]) * scale;
          Ps[(ty * TR + i) * PLD + r] = round_to<T>(p);
          dSs[(ty * TR + i) * PLD + r] = round_to<T>(ds);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        float pv[TR], dsv[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          pv[i] = Ps[(ty * TR + i) * PLD + rr];
          dsv[i] = dSs[(ty * TR + i) * PLD + rr];
        }
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          const float dov = dOs[rr * LD + tx + 16 * c];
          const float qv = Qs[rr * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            dva[i][c] = fmaf(pv[i], dov, dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kj = k0 + ty * TR + i;
    if (kj >= Tn) continue;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const size_t at = kvoff + (size_t)kj * HD + tx + 16 * c;
      dk[at] = from_f32<T>(dka[i][c]);
      dv[at] = from_f32<T>(dva[i][c]);
    }
  }
}

template <int HD> constexpr int fwd_smem() {
  return (BQ * (HD + 1) + BKT * (HD + 1) + BQ * PLD) * 4;
}
template <int HD> constexpr int dq_smem() {
  return (2 * BQ * (HD + 1) + BKT * (HD + 1) + BQ * PLD) * 4;
}
template <int HD> constexpr int dkv_smem() {
  return (2 * BKT * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BKT * PLD + 2 * BQ) * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HD>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int BH, int Tn, int G, float scale,
                    int causal, cudaStream_t s) {
  constexpr int bytes = fwd_smem<HD>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Tn + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, HD><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tn, G, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int BH, int Tn, int G, float scale, int causal,
                   cudaStream_t s) {
  constexpr int bytes = dq_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Tn + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<T, HD><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tn, G, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int BHkv, int Tn, int G, float scale,
                    int causal, cudaStream_t s) {
  constexpr int bytes = dkv_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((Tn + BKT - 1) / BKT, BHkv);
  flash_bwd_dkv_kernel<T, HD><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tn, G, scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int dtype, int hd, int rows, int Tn, int G) {
  return (dtype == 0 || dtype == 1) && (hd == 64 || hd == 128) && rows > 0 &&
         Tn > 0 && G > 0 && rows <= 65535;
}

}  // namespace

// Each function dispatches on dtype (0 = float32, 1 = bfloat16) and head
// dim (64 or 128) and returns the CUDA error of its launch (0 = success).
// q, o, dout, dq: (BH, T, hd); k, v, dk, dv: (BH / G, T, hd); lse and
// delta: (BH, T) f32.  All contiguous.
extern "C" {

int flash_fwd(int dtype, int hd, const void* q, const void* k, const void* v,
              void* o, void* lse, int BH, int Tn, int G, float scale,
              int causal, void* stream) {
  if (!shape_ok(dtype, hd, BH, Tn, G) || BH % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t e;
  if (dtype == 0)
    e = hd == 64 ? run_fwd<float, 64>(q, k, v, o, l, BH, Tn, G, scale, causal, s)
                 : run_fwd<float, 128>(q, k, v, o, l, BH, Tn, G, scale, causal, s);
  else
    e = hd == 64
            ? run_fwd<__nv_bfloat16, 64>(q, k, v, o, l, BH, Tn, G, scale, causal, s)
            : run_fwd<__nv_bfloat16, 128>(q, k, v, o, l, BH, Tn, G, scale, causal, s);
  return (int)e;
}

int flash_bwd_dq(int dtype, int hd, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int BH, int Tn, int G,
                 float scale, int causal, void* stream) {
  if (!shape_ok(dtype, hd, BH, Tn, G) || BH % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaError_t e;
  if (dtype == 0)
    e = hd == 64
            ? run_dq<float, 64>(q, k, v, dout, l, d, dq, BH, Tn, G, scale, causal, s)
            : run_dq<float, 128>(q, k, v, dout, l, d, dq, BH, Tn, G, scale, causal, s);
  else
    e = hd == 64 ? run_dq<__nv_bfloat16, 64>(q, k, v, dout, l, d, dq, BH, Tn, G,
                                             scale, causal, s)
                 : run_dq<__nv_bfloat16, 128>(q, k, v, dout, l, d, dq, BH, Tn,
                                              G, scale, causal, s);
  return (int)e;
}

int flash_bwd_dkv(int dtype, int hd, const void* q, const void* k,
                  const void* v, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int BHkv, int Tn,
                  int G, float scale, int causal, void* stream) {
  if (!shape_ok(dtype, hd, BHkv, Tn, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaError_t e;
  if (dtype == 0)
    e = hd == 64 ? run_dkv<float, 64>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                      scale, causal, s)
                 : run_dkv<float, 128>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                       scale, causal, s);
  else
    e = hd == 64 ? run_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, d, dk, dv, BHkv,
                                              Tn, G, scale, causal, s)
                 : run_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, d, dk, dv,
                                               BHkv, Tn, G, scale, causal, s);
  return (int)e;
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
