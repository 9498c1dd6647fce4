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
// are exact in the products, which accumulate in f32); rows with every
// key masked keep m = -inf and normalise through m_safe/corr; P.V at f32
// accuracy even for bf16 inputs; a zero denominator reads as 1; D rounds
// ds to k's dtype before ds.k, E rounds p to do's dtype and ds to q's
// dtype.  The TPU carried the online-softmax state and the dq/dk/dv
// accumulators in VMEM scratch across a sequential grid axis; here that
// axis is a loop inside the block, the accumulators stay in registers
// until the single write, causal tiles wholly above the diagonal are
// skipped (the TPU's pl.when) and ragged T is masked, so any T is taken.
// hd is 64 or 128.  No atomics: each block owns its output tile, so
// results are bitwise the same from run to run.
//
// What bounds C and E on an H100: at T = 2048, hd = 128 the work is
// T^2 * hd * BH / 2 multiply-adds a product, 2 products in C and 4 in E;
// both are bound by operations, not bytes: f32 on the CUDA cores (67
// TFLOP/s), bf16 on the tensor cores (989 TFLOP/s).  Each has two
// variants, picked by dtype (ops/flash_kernel.py's _variant):
//
// * simt (f32): register-blocked tiles on the CUDA cores, each thread 8
//   rows by 4 or 8 columns of every product so a float4 read feeds 8 or
//   16 FMAs.  C keeps Q^T resident and streams K^T slices (transposed
//   through registers) and V slices (cp.async) through a double buffer,
//   with both products on fused_tiles.cuh's simt_stage; q tiles are
//   issued heaviest first under causal masking.  E keeps K and V
//   resident and one Q and one dO tile in flight, all in XOR-swizzled
//   rows that both of its walks read as float4s without bank conflicts,
//   in 112 KB at hd 128 so two blocks share an SM.
// * wgmma (bf16, sm_90a): one warpgroup a block, products by
//   wgmma.mma_async from 128-byte-swizzled shared memory filled by a
//   two-stage cp.async ring.  C holds Q's A fragments in registers and
//   forms P's from the S accumulator; P.V runs as two bf16 products (P's
//   bf16 part and its remainder's), keeping f32-level accuracy for 1.5x
//   the tensor-core work.  E reads K and V as A by descriptor (its four
//   accumulators fill the registers), forms bf16(P) and bf16(dS) in
//   registers, and reads the same Q and dO tiles K-major for S^T, dP^T
//   and MN-major (transpose bit) for dK, dV.
//
// D is the first port's design, written to be right: 256 threads on a
// 16 x 16 grid, f32 tiles padded to hd + 1 floats, K and V through one
// buffer in turn, every product an FMA loop on the CUDA cores (bf16
// widened).  Its redesign is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "fused_tiles.cuh"

namespace {

using ft::bf16;

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

template <int HD> constexpr int dq_smem() {
  return (2 * BQ * (HD + 1) + BKT * (HD + 1) + BQ * PLD) * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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

// ---------------------------------------------------------------------------
// C, f32: register-blocked tiles on the CUDA cores
// ---------------------------------------------------------------------------

// Row-major f32 tiles in 16-byte chunks, the chunk index XOR-swizzled:
// chunk c of row r lies at chunk c ^ ((r >> SH) & 7) of its row.  A dot
// walk (a product contracting over the row's chunks) reads 16 consecutive
// rows at one chunk, or rows 8 apart, and the swizzle puts them on
// distinct banks; a column walk (contracting over rows) reads one row,
// whose chunks stay a permutation of themselves.  The XOR depends only on
// the thread and on the loop's unrolled position, so it is computed once
// per unrolled step and the inner loops are loads and FMAs.  SH < 0: no
// swizzle (a tile read by ft::simt_stage).
template <int L, int SH>
__device__ __forceinline__ int swz(int r, int c) {
  return SH < 0 ? r * L + c * 4 : r * L + ((c ^ ((r >> SH) & 7)) << 2);
}

// rows [row0, row0 + R) x floats [col0, col0 + L) of a row-major slab of
// row length ld into a swizzled R x L tile by 16-byte cp.async chunks,
// zero-filled past `rows`
template <int R, int L, int SH, int NTH>
__device__ __forceinline__ void load_swz(float* dst, const float* src,
                                         int ld, int row0, int col0,
                                         int rows, int tid) {
  static_assert((R * L / 4) % NTH == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < R * L / 4 / NTH; ++j) {
    const int c = tid + j * NTH, r = c / (L / 4), ch = c % (L / 4);
    const bool ok = row0 + r < rows;
    ft::cp_async16(dst + swz<L, SH>(r, ch),
                   ok ? src + (size_t)(row0 + r) * ld + col0 + ch * 4 : src,
                   ok);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// the float4 at byte offset `off` of dynamic shared memory
__device__ __forceinline__ float4 lds4(const float* base, int off) {
  return *reinterpret_cast<const float4*>(
      reinterpret_cast<const char*>(base) + off);
}

// A block: 64 query rows against 64-key tiles, 128 threads.  Q stays
// resident, row-major and swizzled.  Each key tile streams as HD / 32 K
// stages (32 d of 64 keys) and 64 / VK V stages (VK keys x HD), all 8 KB
// and copied as they are by cp.async into a ring of three, so two stages
// are in flight while one multiplies, one barrier a stage.  S = Q K^T is
// a dot walk over d (thread (ty, tx) owns query rows ft::simt_row(i, ty)
// and keys tx + 16 j: 8 x 4 outputs from 12 float4 reads per 4 d); O += P
// V is ft::simt_stage over P stored key-major (rows simt_row(i, ty),
// columns simt_col(c, tx)).  The 16 threads of a row are one half-warp.
template <int HD>
struct FwdSimt {
  static constexpr int NT = 128, BQ = 64, BK = 64, KD = 32, RING = 3;
  static_assert(KD == 32, "a K stage row is one swizzle period");
  static constexpr int MR = 64 * 16 / NT;            // query rows a thread
  static constexpr int STAGE = 64 * KD;              // floats of a stage
  static constexpr int VK = STAGE / HD;              // keys a V stage
  static constexpr int KST = HD / KD, NST = KST + BK / VK;
  typedef ft::SimtCfg<BQ, HD, VK, MR, HD / 16> CO;   // O += P V
  static constexpr int BYTES = (HD * BQ + RING * STAGE + BK * BQ) * 4;
  static_assert(CO::NT == NT && KD * BK == STAGE && VK * HD == STAGE,
                "one thread grid, equal stages");
};

template <int HD>
__global__ void __launch_bounds__(FwdSimt<HD>::NT, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Tn, int G, float scale,
               int causal) {
  typedef FwdSimt<HD> C;
  typedef typename C::CO CO;
  constexpr int BQ = C::BQ, BK = C::BK, KD = C::KD, VK = C::VK;
  constexpr int KST = C::KST, NST = C::NST, TN = HD / 16, RING = C::RING;
  constexpr int MR = C::MR, NTY = CO::NTY;
  extern __shared__ float smem[];
  // byte offsets: Q (BQ x HD), the ring, P (BK x BQ, key-major)
  constexpr int QS = 0, RS = HD * BQ * 4, PS = RS + RING * C::STAGE * 4;
  float* Ps = smem + PS / 4;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x;
  const int nqt = (Tn + BQ - 1) / BQ;
  // causal: the query tiles with the most key tiles are issued first
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const size_t qoff = (size_t)b * Tn * HD;
  const size_t kvoff = (size_t)(b / G) * Tn * HD;
  const int nkt = (Tn + BK - 1) / BK;
  // causal: key tiles wholly above the diagonal see no query of this tile
  const int kt_end = causal ? min(nkt, (q0 + BQ - 1) / BK + 1) : nkt;
  const int total = kt_end * NST;

  // stage g into ring slot g % RING: a K stage (keys x 32 d, swizzled by
  // row) or a V stage (VK keys x HD as stored); rows past T zero-filled
  auto issue = [&](int g) {
    if (g < total) {
      const int kt = g / NST, st = g % NST;
      float* slot = smem + RS / 4 + (g % RING) * C::STAGE;
      if (st < KST)
        load_swz<BK, KD, 0, C::NT>(slot, k + kvoff, HD, kt * BK, st * KD,
                                   Tn, tid);
      else
        load_swz<VK, HD, -1, C::NT>(slot, v + kvoff, HD,
                                   kt * BK + (st - KST) * VK, 0, Tn, tid);
    }
    ft::cp_async_commit();
  };
  load_swz<BQ, HD, 0, C::NT>(smem, q + qoff, HD, q0, 0, Tn, tid);
  issue(0);
  issue(1);

  float acc[MR][TN], s[MR][4], m[MR], l[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }

  for (int g = 0; g < total; ++g) {
    const int st = g % NST;
    ft::cp_async_wait_group<1>();  // stage g landed (and Q)
    __syncthreads();               // stage g - 1's slot is free
    issue(g + 2);
    const int cur = RS + (g % RING) * C::STAGE * 4;
    if (st < KST) {
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      // s[i][j] += Q[simt_row(i)][st KD ..] . K[tx + 16 j][..]
#pragma unroll
      for (int x = 0; x < KD / 4; ++x) {
        // chunk x of key row tx + 16 j sits at x ^ (tx & 7); of query row
        // simt_row(i, ty) (row mod 8: 4 (ty & 1) + i % 4) at x ^ that
        float4 kf[4];
        const int ko = cur + tx * KD * 4 + ((x ^ (tx & 7)) << 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) kf[j] = lds4(smem, ko + j * 16 * KD * 4);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int qo = QS + ty * 4 * HD * 4 + st * KD * 4 +
                         ((x ^ (i & 3) ^ (4 * (ty & 1))) << 4);
          const float4 qf =
              lds4(smem, qo + ((i >> 2) * NTY * 4 + (i & 3)) * HD * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qf, kf[j], s[i][j]);
        }
      }
    } else {
      ft::simt_stage<CO>(Ps + (st - KST) * VK * BQ,
                         smem + cur / 4, acc, ty, tx);
    }
    if (st != KST - 1) continue;

    // S is whole: the online softmax, P to shared memory.  Masks only on
    // tiles that cross the diagonal or T; exp(-inf) = 0 gives masked p
    // and the corr of rows still all masked without a branch.
    const int k0 = (g / NST) * BK;
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + ft::simt_row<CO>(i, ty), kj = k0 + tx + 16 * j;
        const float x = __fmul_rn(s[i][j], scale);  // as (q.k) * scale
        s[i][j] = edge && (kj >= Tn || (causal && kj > qi)) ? -INFINITY : x;
      }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) bm = fmaxf(bm, s[i][j]);
      bm = row_max(bm);
      const float m_new = fmaxf(m[i], bm);
      // rows with every key masked so far keep m = -inf
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        s[i][j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] *= corr;
    }
    // the last tile's P readers passed this stage's barrier
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < MR / 4; ++h)
        *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * BQ + h * NTY * 4 +
                                   ty * 4) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                        s[4 * h + 3][j]);
    __syncthreads();
  }
  ft::cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int qi = q0 + ft::simt_row<CO>(i, ty);
    if (qi >= Tn) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < TN; c += 4)
      *reinterpret_cast<float4*>(o + qoff + (size_t)qi * HD +
                                 ft::simt_col<CO>(c, tx)) =
          make_float4(acc[i][c] / denom, acc[i][c + 1] / denom,
                      acc[i][c + 2] / denom, acc[i][c + 3] / denom);
    if (tx == 0)
      lse[(size_t)b * Tn + qi] = (m[i] == -INFINITY ? 0.f : m[i]) + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// E, f32: register-blocked tiles on the CUDA cores
// ---------------------------------------------------------------------------

// A block owns 64 keys and walks 32-row query tiles (over the G q-heads
// of its kv group), 128 threads.  K and V stay resident; one Q and one dO
// tile are in flight (112 KB at hd 128, so two blocks share an SM): Q
// loads while dP^T multiplies, the next dO while dK multiplies.  In the
// dot walks (S^T, dP^T) thread (dy, dx) = (tid / 8, tid % 8) owns keys
// 4 dy .. 4 dy + 3 and queries dx + 8 jj: 16 outputs from 8 float4
// reads per 4 d.  In the column walks (dK, dV) thread (ty, tx) = (tid /
// 16, tid % 16) owns keys 8 ty .. 8 ty + 7 and columns 4 (tx + 16 c) ..
// + 3: 32 or 64 outputs from 4 float4 reads per query.  K and V rows are
// swizzled by their 4-row group (a warp reads rows 4 apart), Q and dO
// rows by the row (8 consecutive rows in the dot walks, one row in the
// column walks); P and dS are plain, query-major.
template <int HD>
struct BwdSimt {
  static constexpr int NT = 128, BK = 64, BQ = 32;
  static constexpr int BYTES =
      (2 * BK * HD + 2 * BQ * HD + 2 * BQ * BK + 2 * BQ) * 4;
};

template <int HD>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Tn, int G, float scale,
                   int causal) {
  constexpr int BK = 64, BQ = 32, NTH = 128, NC = HD / 64;
  extern __shared__ float smem[];
  // byte offsets within smem
  constexpr int KS = 0, VS = KS + BK * HD * 4, QS = VS + BK * HD * 4;
  constexpr int DOS = QS + BQ * HD * 4, PS = DOS + BQ * HD * 4;
  constexpr int DSS = PS + BQ * BK * 4, LS = DSS + BQ * BK * 4;
  constexpr int DS = LS + BQ * 4;
  float* Ls = smem + LS / 4;
  float* Ds = smem + DS / 4;
  const int tid = threadIdx.x;
  const int dy = tid / 8, dx = tid % 8, ty = tid / 16, tx = tid % 16;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BK;
  const size_t kvoff = (size_t)bkv * Tn * HD;
  load_swz<BK, HD, 2, NTH>(smem + KS / 4, k + kvoff, HD, k0, 0, Tn, tid);
  load_swz<BK, HD, 2, NTH>(smem + VS / 4, v + kvoff, HD, k0, 0, Tn, tid);

  const int nqt = (Tn + BQ - 1) / BQ;
  // causal: query tiles wholly above this key tile see none of it
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = nqt - qt0, total = G * nq;
  auto issue_do = [&](int i) {
    const int bq = bkv * G + i / nq, q0 = (qt0 + i % nq) * BQ;
    load_swz<BQ, HD, 0, NTH>(smem + DOS / 4, dout + (size_t)bq * Tn * HD, HD,
                             q0, 0, Tn, tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < Tn;
      const float* src = (tid < BQ ? lse : delta) + (size_t)bq * Tn + q0 + r;
      ft::cp_async4((tid < BQ ? Ls : Ds) + r, ok ? src : lse, ok);
    }
  };
  issue_do(0);
  ft::cp_async_commit();

  float dka[8][4 * NC], dva[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // acc[ii][jj] += sum_d A[4 dy + ii][d] B[dx + 8 jj][d]; the swizzle of
  // A row 4 dy + ii is dy & 7, of B row dx + 8 jj is dx
  auto dot_walk = [&](float (&acc)[4][4], int a_tile, int b_tile) {
    const int ab = a_tile + dy * 4 * HD * 4, bb = b_tile + dx * HD * 4;
#pragma unroll 1
    for (int c8 = 0; c8 < HD / 32; ++c8) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int ao = ab + c8 * 128 + ((x ^ (dy & 7)) << 4);
        const int bo = bb + c8 * 128 + ((x ^ dx) << 4);
        float4 bf[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bf[jj] = lds4(smem, bo + jj * 8 * HD * 4);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 a = lds4(smem, ao + ii * HD * 4);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = dot4(a, bf[jj], acc[ii][jj]);
        }
      }
    }
  };
  // acc[ii][4 c + e] += sum_r A[r][8 ty + ii] B[r][4 (tx + 16 c) + e]; B
  // row r = 8 r8 + x has column chunk tx at tx ^ x
  auto col_walk = [&](float (&acc)[8][4 * NC], int a_tile, int b_tile) {
#pragma unroll 1
    for (int r8 = 0; r8 < BQ / 8; ++r8) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int r = 8 * r8 + x;
        const int ao = a_tile + r * BK * 4 + ty * 32;
        const float4 a0 = lds4(smem, ao), a1 = lds4(smem, ao + 16);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const int bo = b_tile + r * HD * 4 + ((tx ^ x) << 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 b = lds4(smem, bo + c * 256);
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            acc[ii][4 * c] = fmaf(av[ii], b.x, acc[ii][4 * c]);
            acc[ii][4 * c + 1] = fmaf(av[ii], b.y, acc[ii][4 * c + 1]);
            acc[ii][4 * c + 2] = fmaf(av[ii], b.z, acc[ii][4 * c + 2]);
            acc[ii][4 * c + 3] = fmaf(av[ii], b.w, acc[ii][4 * c + 3]);
          }
        }
      }
    }
  };

  for (int i = 0; i < total; ++i) {
    const int bq = bkv * G + i / nq, q0 = (qt0 + i % nq) * BQ;
    load_swz<BQ, HD, 0, NTH>(smem + QS / 4, q + (size_t)bq * Tn * HD, HD, q0,
                             0, Tn, tid);
    ft::cp_async_commit();
    ft::cp_async_wait_group<1>();  // dO, lse, delta (and K, V) landed
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
    dot_walk(dp, VS, DOS);
    ft::cp_async_wait_all();  // Q landed
    __syncthreads();
    dot_walk(s, KS, QS);
    // p = exp(s - lse), ds = p (dp - delta) scale (f32: the casts to do's
    // and q's dtype are exact); P and dS query-major
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = dx + 8 * jj, qi = q0 + r;
      const float lr = Ls[r], dr = Ds[r];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int kj = k0 + dy * 4 + ii;
        const bool masked = qi >= Tn || kj >= Tn || (causal && kj > qi);
        // exp(-inf) = 0: masked p without a branch
        const float p =
            expf(masked ? -INFINITY : __fmul_rn(s[ii][jj], scale) - lr);
        s[ii][jj] = p;
        dp[ii][jj] = p * (dp[ii][jj] - dr) * scale;
      }
      const int at = r * BK + dy * 4;
      *reinterpret_cast<float4*>(smem + PS / 4 + at) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
      *reinterpret_cast<float4*>(smem + DSS / 4 + at) =
          make_float4(dp[0][jj], dp[1][jj], dp[2][jj], dp[3][jj]);
    }
    __syncthreads();
    col_walk(dva, PS, DOS);  // dV += P^T dO
    __syncthreads();         // dO, lse and delta are read
    if (i + 1 < total) issue_do(i + 1);
    ft::cp_async_commit();
    col_walk(dka, DSS, QS);  // dK += dS^T Q
    __syncthreads();         // Q, P and dS are read
  }
  ft::cp_async_wait_all();

#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int kj = k0 + ty * 8 + ii;
    if (kj >= Tn) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t at = kvoff + (size_t)kj * HD + 4 * (tx + 16 * c);
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dka[ii][4 * c], dka[ii][4 * c + 1], dka[ii][4 * c + 2],
                      dka[ii][4 * c + 3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dva[ii][4 * c], dva[ii][4 * c + 1], dva[ii][4 * c + 2],
                      dva[ii][4 * c + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// C and E, bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 t) {
  return *reinterpret_cast<const uint32_t*>(&t);
}

// {lo, hi} rounded to bf16, lo in the low half (an A fragment's pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(__floats2bfloat162_rn(lo, hi));
}

// {a, b} as the bf16 pair hi plus the bf16 pair lo of what hi leaves:
// hi + lo carries about 16 bits of each value, where hi alone carries 8
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16_bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);  // exact differences
}

template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) ft::wg_pin(r[i]);
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ft::wg_pin(r[i][e]);
}

// the A fragments of a k16 step from a 64 x 64 f32 accumulator (the
// m64n64 layout): k16 step kk is column blocks 2 kk and 2 kk + 1, whose
// elements a thread holds at 4 j + 2 h + {0, 1} for row g + 8 h; e = 2
// (j - 2 kk) + h is mma.m16n8k16's A register order
__device__ __forceinline__ int frag_idx(int kk, int e) {
  return 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
}

// A block is one warpgroup: 64 query rows (m64) against 64-key tiles.
// Q's A fragments are loaded once into registers.  K and V tiles arrive
// by cp.async into 128-byte-swizzled shared memory, a ring of two stages:
// tile kt + 1 lands while tile kt multiplies.  S = Q K^T is
// m64n64k16 with K read K-major by descriptor; the online softmax runs on
// the accumulator layout (a row's 64 values sit in the 4 threads of a
// quad); O += P V is m64n{HD}k16 with P's A fragments taken from the S
// accumulator in registers and V read MN-major (its rows are the
// contraction, hd contiguous) by descriptor with the transpose bit.  P is
// split into two bf16 parts and multiplied twice, so P.V keeps about 16
// bits of each probability, as the TPU kernel's f32 P.V does to within
// the f32 tolerance; a single bf16 P would keep 8.
template <int HD>
struct FwdWg {
  static constexpr int NT = 128, BQ = 64, BK = 64;
  static constexpr int TILE = BK * HD * 2;           // bytes of a K or V tile
  static constexpr int BYTES = 1024 + 2 * 2 * TILE;  // alignment, two stages
};

template <int HD>
__global__ void __launch_bounds__(128, 2)
flash_fwd_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int Tn, int G, float scale,
             int causal) {
  typedef FwdWg<HD> C;
  constexpr int BQ = C::BQ, BK = C::BK, KS = HD / 16, TILE = C::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int b = blockIdx.x;
  const int nqt = (Tn + BQ - 1) / BQ;
  // causal: the query tiles with the most key tiles are issued first
  const int q0 = (causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const size_t qoff = (size_t)b * Tn * HD;
  const size_t kvoff = (size_t)(b / G) * Tn * HD;
  const int nkt = (Tn + BK - 1) / BK;
  const int kt_end = causal ? min(nkt, (q0 + BQ - 1) / BK + 1) : nkt;

  auto issue = [&](int kt) {
    unsigned char* st = base + (kt & 1) * 2 * TILE;
    ft::load_sw128<BK, HD, C::NT>(st, k + kvoff, kt * BK, Tn, tid);
    ft::load_sw128<BK, HD, C::NT>(st + TILE, v + kvoff, kt * BK, Tn, tid);
  };
  issue(0);
  ft::cp_async_commit();

  // this thread's rows r0 and r0 + 8; Q's A fragments while tile 0 lands
  const int r0 = q0 + w * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1);
      const int col = ks * 16 + 8 * (e >> 1) + 2 * q4;
      qa[ks][e] = row < Tn ? __ldg(reinterpret_cast<const unsigned int*>(
                                 q + qoff + (size_t)row * HD + col))
                           : 0u;
    }
  float acc[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    ft::cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile kt landed; tile kt - 1's products are done
    if (kt + 1 < kt_end) issue(kt + 1);
    ft::cp_async_commit();
    const uint32_t ka = ft::smem_addr(base + (kt & 1) * 2 * TILE);
    const uint32_t va = ka + TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    ft::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ft::wgmma_rs<64, 0>(
          s, qa[ks], ft::wg_desc_sw128(ka + (ks >> 2) * BK * 128) + 2 * (ks & 3));
    ft::wg_commit();
    ft::wg_wait<0>();
    pin(s);

    // s[4 j + 2 h + e]: row r0 + 8 h, key k0 + 8 j + 2 q4 + e.  Masks only
    // on tiles that cross the diagonal or T; exp(-inf) = 0 gives masked p
    // and the corr of rows still all masked without a branch.
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int qi = r0 + 8 * ((x >> 1) & 1), kj = k0 + 8 * (x >> 2) + 2 * q4 + (x & 1);
      const float y = __fmul_rn(s[x], scale);
      s[x] = edge && (kj >= Tn || (causal && kj > qi)) ? -INFINITY : y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bm = fmaxf(bm, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
      const float m_new = fmaxf(m[h], bm);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[h] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[4 * j + 2 * h + e] - m_safe);
          s[4 * j + 2 * h + e] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[h] = l[h] * corr + ps;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 2 * h] *= corr;
        acc[4 * j + 2 * h + 1] *= corr;
      }
    }
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = frag_idx(kk, e);
        split_bf16(s[x], s[x + 1], ph[kk][e], pl[kk][e]);
      }
    pin(acc);
    ft::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ft::wgmma_rs<HD, 1>(acc, ph[kk],
                          ft::wg_desc_sw128_mn(va + kk * 2048, BK * 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ft::wgmma_rs<HD, 1>(acc, pl[kk],
                          ft::wg_desc_sw128_mn(va + kk * 2048, BK * 128));
    ft::wg_commit();
    ft::wg_wait<0>();
    pin(acc);
    pin(ph);
    pin(pl);
  }
  ft::cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    if (qi >= Tn) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + qoff + (size_t)qi * HD + 8 * j +
                                         2 * q4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / denom,
                                acc[4 * j + 2 * h + 1] / denom);
    if (q4 == 0)
      lse[(size_t)b * Tn + qi] = (m[h] == -INFINITY ? 0.f : m[h]) + logf(denom);
  }
}

// A block is one warpgroup owning 64 keys (m64); it walks 64-row query
// tiles over the G q-heads of its kv group.  K and V stay resident in
// 128-byte-swizzled shared memory and are read as A by descriptor (the
// SS form): dK and dV (64 + 64 registers a thread at hd 128) and S^T,
// dP^T (32 + 32) leave no room for them in registers.  Q, dO, lse and
// delta tiles come by cp.async, a ring of two stages.  Per query tile:
//   S^T = K Q^T, dP^T = V dO^T   m64n64k16, A and B K-major
//   dV += bf16(P)^T dO, dK += bf16(dS)^T Q   m64n{HD}k16, A from the
//   S^T / dP^T accumulators in registers, B (dO, Q) MN-major: the same
//   tiles, read along their rows with the transpose bit.
template <int HD>
struct BwdWg {
  static constexpr int NT = 128, BK = 64, BQ = 64;
  static constexpr int TILE = 64 * HD * 2;
  static constexpr int STAGE = 2 * TILE + 1024;  // Q, dO, lse and delta
  static constexpr int BYTES = 1024 + 2 * TILE + 2 * STAGE;
};

template <int HD>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dkv_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Tn, int G, float scale,
                 int causal) {
  typedef BwdWg<HD> C;
  constexpr int BK = C::BK, BQ = C::BQ, KS = HD / 16, TILE = C::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base + 2 * TILE;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BK;
  const size_t kvoff = (size_t)bkv * Tn * HD;
  ft::load_sw128<BK, HD, C::NT>(base, k + kvoff, k0, Tn, tid);
  ft::load_sw128<BK, HD, C::NT>(base + TILE, v + kvoff, k0, Tn, tid);

  const int nqt = (Tn + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = nqt - qt0, total = G * nq;
  auto issue = [&](int i) {
    unsigned char* st = ring + (i & 1) * C::STAGE;
    const int bq = bkv * G + i / nq, q0 = (qt0 + i % nq) * BQ;
    const size_t qoff = (size_t)bq * Tn * HD;
    ft::load_sw128<BQ, HD, C::NT>(st, q + qoff, q0, Tn, tid);
    ft::load_sw128<BQ, HD, C::NT>(st + TILE, dout + qoff, q0, Tn, tid);
    // lse at [0, 64), delta at [64, 128)
    const int r = tid & 63;
    const bool ok = q0 + r < Tn;
    const float* src = (tid < 64 ? lse : delta) + (size_t)bq * Tn + q0 + r;
    ft::cp_async4(reinterpret_cast<float*>(st + 2 * TILE) + tid,
                  ok ? src : lse, ok);
  };
  issue(0);
  ft::cp_async_commit();

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  const int kr = k0 + w * 16 + g;  // this thread's keys kr and kr + 8
  const uint32_t ka = ft::smem_addr(base), va = ka + TILE;

  for (int i = 0; i < total; ++i) {
    const int q0 = (qt0 + i % nq) * BQ;
    ft::cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile i landed; tile i - 1's products are done
    if (i + 1 < total) issue(i + 1);
    ft::cp_async_commit();
    unsigned char* st = ring + (i & 1) * C::STAGE;
    const uint32_t qa = ft::smem_addr(st), da = qa + TILE;
    const float* Ls = reinterpret_cast<const float*>(st + 2 * TILE);
    const float* Ds = Ls + 64;

    float sT[32], dpT[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sT[x] = dpT[x] = 0.f;
    pin(sT);
    pin(dpT);
    ft::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t blk = (ks >> 2) * 64 * 128, sub = 2 * (ks & 3);
      ft::wgmma_ss<64>(sT, ft::wg_desc_sw128(ka + blk) + sub,
                       ft::wg_desc_sw128(qa + blk) + sub);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t blk = (ks >> 2) * 64 * 128, sub = 2 * (ks & 3);
      ft::wgmma_ss<64>(dpT, ft::wg_desc_sw128(va + blk) + sub,
                       ft::wg_desc_sw128(da + blk) + sub);
    }
    ft::wg_commit();
    ft::wg_wait<0>();
    pin(sT);
    pin(dpT);

    // sT[4 j + 2 h + e]: key kr + 8 h, query q0 + 8 j + 2 q4 + e;
    // p = exp(s - lse) and ds = p (dp - delta) scale in f32, then p
    // rounded to do's dtype and ds to q's (bf16) as A fragments
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = frag_idx(kk, e), h = e & 1;
        const int kj = kr + 8 * h;
        float p2[2], ds2[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = 8 * (2 * kk + (e >> 1)) + 2 * q4 + t, qi = q0 + c;
          const bool masked = qi >= Tn || kj >= Tn || (causal && kj > qi);
          const float p =
              expf(masked ? -INFINITY : __fmul_rn(sT[x + t], scale) - Ls[c]);
          p2[t] = p;
          ds2[t] = p * (dpT[x + t] - Ds[c]) * scale;
        }
        pa[kk][e] = pack_bf16(p2[0], p2[1]);
        dsa[kk][e] = pack_bf16(ds2[0], ds2[1]);
      }
    pin(dva);
    pin(dka);
    ft::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ft::wgmma_rs<HD, 1>(dva, pa[kk],
                          ft::wg_desc_sw128_mn(da + kk * 2048, BQ * 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ft::wgmma_rs<HD, 1>(dka, dsa[kk],
                          ft::wg_desc_sw128_mn(qa + kk * 2048, BQ * 128));
    ft::wg_commit();
    ft::wg_wait<0>();
    pin(dva);
    pin(dka);
    pin(pa);
    pin(dsa);
  }
  ft::cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = kr + 8 * h;
    if (kj >= Tn) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const size_t at = kvoff + (size_t)kj * HD + 8 * j + 2 * q4;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
          dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

template <int HD>
cudaError_t run_fwd_simt(const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int Tn, int G,
                         float scale, int causal, cudaStream_t s) {
  typedef FwdSimt<HD> C;
  static const cudaError_t attr =
      ft::allow_smem(flash_fwd_simt<HD>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(BH, (Tn + C::BQ - 1) / C::BQ);
  flash_fwd_simt<HD><<<grid, C::NT, C::BYTES, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tn, G,
      scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_fwd_wg(const void* q, const void* k, const void* v, void* o,
                       float* lse, int BH, int Tn, int G, float scale,
                       int causal, cudaStream_t s) {
  typedef FwdWg<HD> C;
  static const cudaError_t attr = ft::allow_smem(flash_fwd_wg<HD>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(BH, (Tn + C::BQ - 1) / C::BQ);
  flash_fwd_wg<HD><<<grid, C::NT, C::BYTES, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Tn, G, scale,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_dkv_simt(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int BHkv,
                         int Tn, int G, float scale, int causal,
                         cudaStream_t s) {
  typedef BwdSimt<HD> C;
  static const cudaError_t attr =
      ft::allow_smem(flash_bwd_dkv_simt<HD>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(BHkv, (Tn + C::BK - 1) / C::BK);
  flash_bwd_dkv_simt<HD><<<grid, C::NT, C::BYTES, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), Tn, G, scale,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_dkv_wg(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int BHkv,
                       int Tn, int G, float scale, int causal,
                       cudaStream_t s) {
  typedef BwdWg<HD> C;
  static const cudaError_t attr =
      ft::allow_smem(flash_bwd_dkv_wg<HD>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid(BHkv, (Tn + C::BK - 1) / C::BK);
  flash_bwd_dkv_wg<HD><<<grid, C::NT, C::BYTES, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tn, G, scale,
      causal);
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
    e = hd == 64 ? run_fwd_simt<64>(q, k, v, o, l, BH, Tn, G, scale, causal, s)
                 : run_fwd_simt<128>(q, k, v, o, l, BH, Tn, G, scale, causal, s);
  else
    e = hd == 64 ? run_fwd_wg<64>(q, k, v, o, l, BH, Tn, G, scale, causal, s)
                 : run_fwd_wg<128>(q, k, v, o, l, BH, Tn, G, scale, causal, s);
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
    e = hd == 64 ? run_dkv_simt<64>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                    scale, causal, s)
                 : run_dkv_simt<128>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                     scale, causal, s);
  else
    e = hd == 64 ? run_dkv_wg<64>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                  scale, causal, s)
                 : run_dkv_wg<128>(q, k, v, dout, l, d, dk, dv, BHkv, Tn, G,
                                   scale, causal, s);
  return (int)e;
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
