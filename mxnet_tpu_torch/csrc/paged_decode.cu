// Kernel B: paged split-K flash decoding with in-kernel dequantization,
// and the combine of its split partials.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_decode.py `_kernel`
// (launched by `_paged_flash_call`) and the jnp logsumexp combine after
// it (pallas_decode.py:354-366).  Queries (B, tq, H*Dk) attend a slot's
// ring view of the shared page pools: view slot v of slot b lives at
// pool[table[b, v / pt], v % pt].  Query row i of a window whose total
// appended length is `total` sees view slots
//     v < min(total - (tq - 1) + i, C),   C = M * pt
// (the length/wrap mask of pallas_decode.py:211-217).  Grouped-query
// attention: q-head h reads kv-head h / G.  int8 / fp8 pools carry one
// f32 scale per (token, kv-head); each element is dequantized in
// registers as it is used (k = k_int * k_scale, as the TPU kernel
// computes it); fp8 bytes convert through __nv_cvt_fp8_to_halfraw.
//
// The view's M pages are cut into S splits of `pps` pages (Flash-
// Decoding); S comes from the card's SM count (ops/decode_kernel.py's
// _plan), not from the live lengths, which stay on the device.  A block
// serves one (split, kv-head, slot) and all the rows of the window that
// read that kv-head (G q-heads x tq queries, flattened gq-major), so each
// page is read once per kv-head.  It reads its split's page-table slice
// once, walks only the tokens its rows can see (a split wholly past the
// live length exits at once with m = -inf, l = 0) and writes the
// UNNORMALISED partial (acc, m, l) of each row.  The combine kernel
// reduces the partials of every split in a fixed order (no atomics, so
// results repeat bit for bit) and writes (B, tq, H*Dv) in the output
// dtype.
//
// Two variants (_plan picks one):
//
// * decode (tq <= 16: decode steps and verify windows).  Bound by bytes:
//   at the serve's decode every K/V byte is used once per row.  Four
//   warps walk disjoint token groups with their own online softmax,
//   combined through shared memory at the end; a lane owns EPL
//   consecutive dims of every row and token (EPL = hd / 32 at head dims
//   64 / 128 / 256 / 512), loads them with one vector load (a 256-wide
//   int8 row is 32 lanes x 8 B, a 128-wide one 32 x 4 B), keeps its
//   slice of q and of the output in registers, and sums a score over
//   the warp with shuffles.  A warp issues the loads of TW tokens
//   before it uses them.  Rows beyond ROWS a block take more blocks (row
//   tiles).
// * chunk (tq > 16, head dims 64 / 128 / 256: the serve's prefill
//   chunks).  Bound by operations.  Kernel C's register-blocked tiles:
//   64 rows resident in XOR-swizzled f32 rows, 64-key tiles streamed as
//   K d-slices (64 keys x 32 d, swizzled) for S = Q K^T as a dot walk and
//   V row stages for P.V on fused_tiles.cuh's simt_stage, each stage
//   fetched into registers, dequantized there and stored as f32 while
//   the previous stage multiplies (double-buffered, one barrier a stage).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "fused_tiles.cuh"

namespace {

enum PoolType { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3, kE5M2 = 4 };

template <int PT>
struct Pool {
  static constexpr int SZ = PT == kF32 ? 4 : PT == kBF16 ? 2 : 1;  // bytes
  static constexpr int EW = 4 / SZ;           // elements a 32-bit word
  static constexpr bool QUANT = PT >= kI8;    // scaled per (token, head)
};

// element j of a 32-bit word of packed pool elements, as f32
template <int PT>
__device__ __forceinline__ float cvt(uint32_t w, int j) {
  if constexpr (PT == kF32) {
    return __uint_as_float(w);
  } else if constexpr (PT == kBF16) {
    return __uint_as_float(j ? (w & 0xffff0000u) : (w << 16));
  } else if constexpr (PT == kI8) {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
  } else {
    const __nv_fp8_storage_t b =
        static_cast<__nv_fp8_storage_t>((w >> (8 * j)) & 0xffu);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        b, PT == kE4M3 ? __NV_E4M3 : __NV_E5M2)));
  }
}

// The N elements at element index idx of `base`, packed into words as
// they lie in memory: one vector load where `vec` (the address aligned
// to N * SZ bytes, up to 16), else one load an element, skipping
// elements at or past `lim` (they read as 0).
template <int PT, int N>
__device__ __forceinline__ void load_raw(
    const void* base, size_t idx, bool vec, int lim,
    uint32_t (&w)[(N * Pool<PT>::SZ + 3) / 4]) {
  constexpr int SZ = Pool<PT>::SZ, BYTES = N * SZ, NW = (BYTES + 3) / 4;
  const unsigned char* p = static_cast<const unsigned char*>(base) + idx * SZ;
  if (vec) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + c);
        w[4 * c] = t.x, w[4 * c + 1] = t.y, w[4 * c + 2] = t.z,
        w[4 * c + 3] = t.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (BYTES == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (BYTES == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e >= lim) break;
    uint32_t x;
    if constexpr (SZ == 4)
      x = __ldg(reinterpret_cast<const unsigned int*>(p) + e);
    else if constexpr (SZ == 2)
      x = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
    else
      x = __ldg(p + e);
    w[e / Pool<PT>::EW] |= x << (8 * SZ * (e % Pool<PT>::EW));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const float* q;         // (B, tq, H * Dk) f32
  const void* kp;         // (P, pt, Hkv * Dk) pools
  const void* vp;         // (P, pt, Hkv * Dv)
  const float* ks;        // (P, pt, Hkv) scales, or null
  const float* vs;
  const int* table;       // (B, M)
  const int* lens;        // (B,) tokens appended, the queries included
  float* acc;             // (B, H, S, tq, Dv) partials
  float* m;               // (B, H, S, tq)
  float* l;
  int tq, H, Hkv, Dk, Dv, pt, M, pps, S, vec;
  float scale;
};

// The block's rows (flattened gq * tq + i over its kv-head's G q-heads):
// [r0, r0 + nr).  Row i sees view slots below min(total - (tq-1) + i, C);
// the least and the largest such limit over the rows.
__device__ __forceinline__ void row_limits(const Args& a, int r0, int nr,
                                           int total, int& lo, int& hi) {
  const int C = a.M * a.pt, last = r0 + nr - 1;
  const bool spans = last / a.tq > r0 / a.tq;
  const int ilo = spans ? 0 : r0 % a.tq;
  const int ihi = spans ? a.tq - 1 : last % a.tq;
  lo = min(total - (a.tq - 1) + ilo, C);
  hi = min(total - (a.tq - 1) + ihi, C);
}

// index of row r's partial (b, h, split, i)
__device__ __forceinline__ size_t part_index(const Args& a, int b, int kvh,
                                             int s, int r) {
  const int G = a.H / a.Hkv, h = kvh * G + r / a.tq;
  return (((size_t)b * a.H + h) * a.S + s) * a.tq + r % a.tq;
}

// ---------------------------------------------------------------------------
// decode variant
// ---------------------------------------------------------------------------

constexpr int kWarps = 4, kThreads = 128;

template <int PT, int EPL, int ROWS>
struct DecodeCfg {
  static constexpr int SZ = Pool<PT>::SZ;
  static constexpr int NW = (EPL * SZ + 3) / 4;   // words a lane a token
  static constexpr int TW0 = 64 / (EPL * SZ);
  // tokens a warp loads before it uses them: 64 B of K and of V a lane
  static constexpr int TW =
      (TW0 < 1 ? 1 : TW0 > 8 ? 8 : TW0) / (ROWS > 1 && TW0 > 1 ? 2 : 1);
};

// grid (S, Hkv * row tiles, B); dynamic shared memory: the split's page
// ids (pps ints, padded to 4) and the four warps' (m, l, acc) per row
template <int PT, int EPL, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_warp(const Args a) {
  typedef DecodeCfg<PT, EPL, ROWS> C;
  constexpr int TW = C::TW, NW = C::NW, EW = Pool<PT>::EW;
  constexpr bool QUANT = Pool<PT>::QUANT;
  extern __shared__ float smem[];
  const int s = blockIdx.x, kvh = blockIdx.y % a.Hkv;
  const int r0 = (blockIdx.y / a.Hkv) * ROWS, b = blockIdx.z;
  const int R = (a.H / a.Hkv) * a.tq, nr = min(ROWS, R - r0);
  const int total = a.lens[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo, hi;
  row_limits(a, r0, nr, total, lo, hi);
  const int p0 = s * a.pps, np = min(a.pps, a.M - p0);
  const int v_begin = p0 * a.pt, v_end = min((p0 + np) * a.pt, hi);
  if (v_begin >= v_end) {  // nothing of this split is visible
    if (tid < nr) {
      const size_t at = part_index(a, b, kvh, s, r0 + tid);
      a.m[at] = -INFINITY;
      a.l[at] = 0.f;
    }
    return;
  }
  int* tab = reinterpret_cast<int*>(smem);
  float* wm = smem + ((a.pps + 3) & ~3);
  float* wl = wm + kWarps * ROWS;
  float* wacc = wl + kWarps * ROWS;
  for (int p = tid; p < np; p += kThreads)
    tab[p] = a.table[(size_t)b * a.M + p0 + p];

  // this lane's dims lane * EPL .. of q, each row's limit
  const int d0 = lane * EPL;
  float qr[ROWS][EPL];
  int lim[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = r0 + rr, i = r % a.tq;
    const int h = kvh * (a.H / a.Hkv) + r / a.tq;
    lim[rr] = rr < nr ? min(total - (a.tq - 1) + i, a.M * a.pt) : 0;
    const float* qrow = a.q + ((size_t)(b * a.tq + i) * a.H + h) * a.Dk;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[rr][e] = rr < nr && d0 + e < a.Dk ? qrow[d0 + e] : 0.f;
  }
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = 0.f;
  }
  const size_t krow = (size_t)a.Hkv * a.Dk, vrow = (size_t)a.Hkv * a.Dv;
  for (int v0 = v_begin + warp * TW; v0 < v_end; v0 += kWarps * TW) {
    // the loads of TW tokens first (a token past the split reads page 0,
    // the scratch page, and is masked)
    uint32_t kw[TW][NW], vw[TW][NW];
    float ksc[TW], vsc[TW];
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      const int v = min(v0 + t, v_end - 1);
      const size_t row = (size_t)tab[v / a.pt - p0] * a.pt + v % a.pt;
      load_raw<PT, EPL>(a.kp, row * krow + (size_t)kvh * a.Dk + d0, a.vec,
                        a.Dk - d0, kw[t]);
      load_raw<PT, EPL>(a.vp, row * vrow + (size_t)kvh * a.Dv + d0, a.vec,
                        a.Dv - d0, vw[t]);
      if (QUANT) {
        ksc[t] = __ldg(a.ks + row * a.Hkv + kvh);
        vsc[t] = __ldg(a.vs + row * a.Hkv + kvh);
      }
    }
    // scores: (q . k) * scale over the warp; masked -> -inf
    float sc[ROWS][TW];
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      float kd[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float x = cvt<PT>(kw[t][e / EW], e % EW);
        kd[e] = QUANT ? __fmul_rn(x, ksc[t]) : x;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[rr][e], kd[e], dot);
        dot = warp_sum(dot);
        const int v = v0 + t;
        sc[rr][t] = v < v_end && v < lim[rr] ? __fmul_rn(dot, a.scale)
                                             : -INFINITY;
      }
    }
    // online softmax per row; exp(-inf) = 0 gives masked p and the corr
    // of a row still all masked
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      float cm = -INFINITY;
#pragma unroll
      for (int t = 0; t < TW; ++t) cm = fmaxf(cm, sc[rr][t]);
      const float m_new = fmaxf(m[rr], cm);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[rr] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        sc[rr][t] = expf(sc[rr][t] - m_safe);
        ps += sc[rr][t];
      }
      l[rr] = l[rr] * corr + ps;
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[rr][e] *= corr;
    }
#pragma unroll
    for (int t = 0; t < TW; ++t)
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float x = cvt<PT>(vw[t][e / EW], e % EW);
        const float vd = QUANT ? __fmul_rn(x, vsc[t]) : x;
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          acc[rr][e] = fmaf(sc[rr][t], vd, acc[rr][e]);
      }
  }

  // the four warps' states, combined in a fixed order
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (lane == 0) {
      wm[warp * ROWS + rr] = m[rr];
      wl[warp * ROWS + rr] = l[rr];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (d0 + e < a.Dv)
        wacc[(warp * ROWS + rr) * a.Dv + d0 + e] = acc[rr][e];
  }
  __syncthreads();
  for (int rr = 0; rr < nr; ++rr) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * ROWS + rr]);
    const float ms = mx == -INFINITY ? 0.f : mx;
    float al[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) al[w] = expf(wm[w * ROWS + rr] - ms);
    const size_t at = part_index(a, b, kvh, s, r0 + rr);
    for (int d = tid; d < a.Dv; d += kThreads) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        x = fmaf(al[w], wacc[(w * ROWS + rr) * a.Dv + d], x);
      a.acc[at * a.Dv + d] = x;
    }
    if (tid == 0) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lt = fmaf(al[w], wl[w * ROWS + rr], lt);
      a.m[at] = mx;
      a.l[at] = lt;
    }
  }
}

// ---------------------------------------------------------------------------
// chunk variant
// ---------------------------------------------------------------------------

// Kernel C's f32 tiles (flash_attention.cu's FwdSimt) over paged,
// quantized K/V: 64 rows, 64-key tiles, 8 KB stages (K d-slices of 64
// keys x 32 d swizzled by row, V row stages of VK keys x HD); 256
// threads at hd 256 so a thread keeps 4 rows x 16 columns of O.
template <int HD>
struct ChunkCfg {
  static constexpr int NT = HD == 256 ? 256 : 128, BQ = 64, BK = 64, KD = 32;
  static constexpr int MR = BQ * 16 / NT;             // rows a thread
  static constexpr int STAGE = BK * KD;               // floats of a stage
  static constexpr int VK = STAGE / HD;               // keys a V stage
  static constexpr int KST = HD / KD, NST = KST + BK / VK;
  static constexpr int PER = STAGE / 8 / NT;          // 8-element groups
  typedef ft::SimtCfg<BQ, HD, VK, MR, HD / 16> CO;    // O += P V
  // Q, two stage buffers, P (BK x BQ, key-major); the page ids follow
  static constexpr int FIXED = (HD * BQ + 2 * STAGE + BK * BQ) * 4;
  static_assert(CO::NT == NT && VK * HD == STAGE && PER >= 1, "one grid");
};

// the most pages a split may hold (the page ids live in shared memory)
constexpr int kMaxSplitPages = 2048;

// grid (S, Hkv * row tiles of 64, B)
template <int PT, int HD>
__global__ void __launch_bounds__(ChunkCfg<HD>::NT)
paged_decode_chunk(const Args a) {
  typedef ChunkCfg<HD> C;
  typedef typename C::CO CO;
  constexpr int BQ = C::BQ, BK = C::BK, KD = C::KD, VK = C::VK, NT = C::NT;
  constexpr int KST = C::KST, NST = C::NST, PER = C::PER, MR = C::MR;
  constexpr int TN = HD / 16, NTY = CO::NTY, NWD = 2 * Pool<PT>::SZ;
  constexpr int EW = Pool<PT>::EW;
  constexpr bool QUANT = Pool<PT>::QUANT;
  extern __shared__ float smem[];
  constexpr int QS = 0, B0 = HD * BQ * 4, PS = B0 + 2 * C::STAGE * 4;
  float* Ps = smem + PS / 4;
  int* tab = reinterpret_cast<int*>(smem + C::FIXED / 4);
  const int s = blockIdx.x, kvh = blockIdx.y % a.Hkv;
  const int r0 = (blockIdx.y / a.Hkv) * BQ, b = blockIdx.z;
  const int R = (a.H / a.Hkv) * a.tq, nr = min(BQ, R - r0);
  const int total = a.lens[b];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  int lo, hi;
  row_limits(a, r0, nr, total, lo, hi);
  const int p0 = s * a.pps, np = min(a.pps, a.M - p0);
  const int v_begin = p0 * a.pt, v_split = (p0 + np) * a.pt;
  const int v_stop = min(v_split, hi);
  if (v_begin >= v_stop) {  // nothing of this split is visible
    for (int r = tid; r < nr; r += NT) {
      const size_t at = part_index(a, b, kvh, s, r0 + r);
      a.m[at] = -INFINITY;
      a.l[at] = 0.f;
    }
    return;
  }
  for (int p = tid; p < np; p += NT) tab[p] = a.table[(size_t)b * a.M + p0 + p];
  // Q rows (gq-major over the kv-head's q-heads), swizzled; rows past R 0
  for (int c = tid; c < BQ * HD / 4; c += NT) {
    const int r = c / (HD / 4), ch = c % (HD / 4), fr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr) {
      const int h = kvh * (a.H / a.Hkv) + fr / a.tq, i = fr % a.tq;
      x = __ldg(reinterpret_cast<const float4*>(
                    a.q + ((size_t)(b * a.tq + i) * a.H + h) * HD) + ch);
    }
    *reinterpret_cast<float4*>(smem + QS / 4 + ft::swz<HD, 0>(r, ch)) = x;
  }
  // each of this thread's rows sees keys below rl (its own limit, cut at
  // the split's end; rows past R see none)
  int rl[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int fr = r0 + ft::simt_row<CO>(i, ty);
    rl[i] = fr < R ? min(min(total - (a.tq - 1) + fr % a.tq, a.M * a.pt),
                         v_split)
                   : 0;
  }
  const int edge_from = min(lo, v_split);  // tiles past it need masks
  const int nkt = (v_stop - v_begin + BK - 1) / BK, total_st = nkt * NST;
  const size_t krow = (size_t)a.Hkv * HD;
  __syncthreads();

  // stage g: raw elements into registers (fetch), dequantized into a
  // stage buffer as f32 (put)
  uint32_t raw[PER][NWD];
  float scl[PER];
  bool live[PER];
  auto coords = [&](int st, int c, int& key, int& dd) {
    if (st < KST) {
      key = c >> 2;
      dd = st * KD + (c & 3) * 8;
    } else {
      key = (st - KST) * VK + c / (HD / 8);
      dd = (c % (HD / 8)) * 8;
    }
  };
  auto fetch = [&](int g) {
    const int st = g % NST, k0 = v_begin + (g / NST) * BK;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int key, dd;
      coords(st, tid + j * NT, key, dd);
      const int v = k0 + key;
      live[j] = v < v_stop;
      const int vv = live[j] ? v : v_begin;
      const size_t row = (size_t)tab[vv / a.pt - p0] * a.pt + vv % a.pt;
      load_raw<PT, 8>(st < KST ? a.kp : a.vp, row * krow + (size_t)kvh * HD + dd,
                      true, 8, raw[j]);
      if (QUANT)
        scl[j] = __ldg((st < KST ? a.ks : a.vs) + row * a.Hkv + kvh);
    }
  };
  auto put = [&](int g) {
    const int st = g % NST;
    float* buf = smem + B0 / 4 + (g & 1) * C::STAGE;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int key, dd;
      coords(st, tid + j * NT, key, dd);
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = cvt<PT>(raw[j][e / EW], e % EW);
        f[e] = !live[j] ? 0.f : QUANT ? __fmul_rn(x, scl[j]) : x;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = st < KST ? buf + ft::swz<KD, 0>(key, (dd % KD) / 4 + h)
                              : buf + key % VK * HD + dd + 4 * h;
        *reinterpret_cast<float4*>(dst) =
            make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
      }
    }
  };
  fetch(0);
  put(0);
  __syncthreads();

  float acc[MR][TN], sc[MR][4], m[MR], l[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }
  for (int g = 0; g < total_st; ++g) {
    const int st = g % NST;
    if (g + 1 < total_st) fetch(g + 1);
    const int cur = B0 + (g & 1) * C::STAGE * 4;
    if (st < KST) {
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      }
      ft::dot_walk_stage<HD, MR, NTY>(sc, smem, QS, cur, st, ty, tx);
    } else {
      ft::simt_stage<CO>(Ps + (st - KST) * VK * BQ, smem + cur / 4, acc, ty,
                         tx);
    }
    if (st == KST - 1) {
      // S is whole: the online softmax, P to shared memory (the last
      // tile's P readers passed the previous stage's barrier).  Masks
      // only on tiles reaching past the rows' least limit.
      const int k0 = v_begin + (g / NST) * BK;
      const bool edge = k0 + BK > edge_from;
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = __fmul_rn(sc[i][j], a.scale);
          sc[i][j] = edge && k0 + tx + 16 * j >= rl[i] ? -INFINITY : x;
        }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        float bm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) bm = fmaxf(bm, sc[i][j]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
        const float m_new = fmaxf(m[i], bm);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = expf(m[i] - m_safe);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = expf(sc[i][j] - m_safe);
          ps += sc[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l[i] = l[i] * corr + ps;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < MR / 4; ++h)
          *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * BQ + h * NTY * 4 +
                                     ty * 4) =
              make_float4(sc[4 * h][j], sc[4 * h + 1][j], sc[4 * h + 2][j],
                          sc[4 * h + 3][j]);
    }
    if (g + 1 < total_st) put(g + 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ft::simt_row<CO>(i, ty);
    if (r >= nr) continue;
    const size_t at = part_index(a, b, kvh, s, r0 + r);
#pragma unroll
    for (int c = 0; c < TN; c += 4)
      *reinterpret_cast<float4*>(a.acc + at * HD + ft::simt_col<CO>(c, tx)) =
          make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
    if (tx == 0) {
      a.m[at] = m[i];
      a.l[at] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the combine
// ---------------------------------------------------------------------------

template <typename OUT>
__device__ __forceinline__ void store4(OUT* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<ft::bf16>(ft::bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// One block per (query row i, q-head h, slot b), 64 threads: out[b, i,
// h Dv ..] = sum_s alpha_s acc_s / sum_s alpha_s l_s, alpha_s = exp(m_s -
// max m).  The alphas are computed once into shared memory and the splits
// that saw something (m_s > -inf; the others' acc is never read)
// compacted into a list in order, so each thread's sum over them issues
// independent loads; every sum runs in a fixed order.  Written in the
// output dtype, (B, tq, H * Dv).  Shared memory: 2 S floats and S ints.
constexpr int kCombineThreads = 64;

template <typename OUT>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ acc,
                     const float* __restrict__ m,
                     const float* __restrict__ l, OUT* __restrict__ out,
                     int tq, int H, int S, int Dv) {
  extern __shared__ float csm[];
  float* al = csm;                                   // S alphas
  float* red = csm + S;                              // S: l terms
  int* live = reinterpret_cast<int*>(csm + 2 * S);   // S split ids
  __shared__ float part[2];
  __shared__ int nlive;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t p0 = ((size_t)b * H + h) * S * tq + i;  // split s: + s tq
  float mx = -INFINITY;
  for (int s = tid; s < S; s += kCombineThreads) {
    al[s] = __ldg(m + p0 + (size_t)s * tq);
    red[s] = __ldg(l + p0 + (size_t)s * tq);
    mx = fmaxf(mx, al[s]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) part[warp] = mx;
  __syncthreads();
  mx = fmaxf(part[0], part[1]);
  const float ms = mx == -INFINITY ? 0.f : mx;
  for (int s = tid; s < S; s += kCombineThreads) {
    al[s] = expf(al[s] - ms);  // exp(-inf) = 0: a split that saw nothing
    red[s] *= al[s];
  }
  __syncthreads();
  // warp 0: the live splits in order, and the l sum in order
  if (warp == 0) {
    int n = 0;
    float lt = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool ok = s < S && al[s] != 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) live[n + __popc(bal & ((1u << lane) - 1))] = s;
      n += __popc(bal);
      for (int t = 0; t < 32 && s0 + t < S; ++t) lt += red[s0 + t];
    }
    if (lane == 0) {
      nlive = n;
      part[0] = lt == 0.f ? 1.f : lt;
    }
  }
  __syncthreads();
  const int n = nlive;
  const float denom = part[0];
  OUT* o = out + ((size_t)b * tq + i) * H * Dv + (size_t)h * Dv;
  if (Dv % 4 == 0) {
    for (int c = tid * 4; c < Dv; c += 4 * kCombineThreads) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int s = live[k];
        const float a = al[s];
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            acc + (p0 + (size_t)s * tq) * Dv + c));
        x.x = fmaf(a, v.x, x.x);
        x.y = fmaf(a, v.y, x.y);
        x.z = fmaf(a, v.z, x.z);
        x.w = fmaf(a, v.w, x.w);
      }
      store4<OUT>(o + c, make_float4(x.x / denom, x.y / denom, x.z / denom,
                                     x.w / denom));
    }
    return;
  }
  for (int c = tid; c < Dv; c += kCombineThreads) {
    float x = 0.f;
    for (int k = 0; k < n; ++k) {
      const int s = live[k];
      x = fmaf(al[s], __ldg(acc + (p0 + (size_t)s * tq) * Dv + c), x);
    }
    o[c] = ft::from_f32<OUT>(x / denom);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int PT, int EPL, int ROWS>
int launch_decode(const Args& a, int B, int rows_total, cudaStream_t st) {
  const int bytes = (((a.pps + 3) & ~3) + 2 * kWarps * ROWS +
                     kWarps * ROWS * a.Dv) * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_warp<PT, EPL, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.S, a.Hkv * ((rows_total + ROWS - 1) / ROWS), B);
  paged_decode_warp<PT, EPL, ROWS><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int PT, int HD>
int launch_chunk(const Args& a, int B, int rows_total, cudaStream_t st) {
  typedef ChunkCfg<HD> C;
  static const cudaError_t attr = ft::allow_smem(
      paged_decode_chunk<PT, HD>, C::FIXED + kMaxSplitPages * 4);
  if (attr != cudaSuccess) return (int)attr;
  const int bytes = C::FIXED + ((a.pps + 3) & ~3) * 4;
  dim3 grid(a.S, a.Hkv * ((rows_total + C::BQ - 1) / C::BQ), B);
  paged_decode_chunk<PT, HD><<<grid, C::NT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int PT>
int launch(int variant, const Args& a, int B, int rows, int epl,
           cudaStream_t st) {
  const int R = (a.H / a.Hkv) * a.tq;
  if (variant == 1) {
    if (a.Dk != a.Dv) return (int)cudaErrorInvalidValue;
    switch (a.Dk) {
      case 64: return launch_chunk<PT, 64>(a, B, R, st);
      case 128: return launch_chunk<PT, 128>(a, B, R, st);
      case 256: return launch_chunk<PT, 256>(a, B, R, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#define MX_DECODE(E)                                       \
  return rows == 1 ? launch_decode<PT, E, 1>(a, B, R, st) \
                   : launch_decode<PT, E, 4>(a, B, R, st)
  switch (epl) {
    case 2: MX_DECODE(2);
    case 4: MX_DECODE(4);
    case 8: MX_DECODE(8);
    case 16: MX_DECODE(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MX_DECODE
}

}  // namespace

extern "C" {

// variant: 0 decode (rows 1 or 4 a block, epl 2 / 4 / 8 / 16 dims a lane), 1
// chunk (Dk = Dv = 64 / 128 / 256); pool_type: 0 f32, 1 bf16, 2 int8, 3
// fp8 e4m3, 4 fp8 e5m2.  kscale / vscale are null for unquantized pools.
// S splits of pps pages cover the M view pages.  Writes the partials acc
// (B, H, S, tq, Dv), m and l (B, H, S, tq); vec: the pools' rows take
// vector loads.  Returns the CUDA error of the launch (0 = cudaSuccess).
int paged_decode(int variant, int pool_type, const void* q, const void* kp,
                 const void* vp, const void* ks, const void* vs,
                 const void* table, const void* lens, void* acc, void* m,
                 void* l, int B, int tq, int H, int Hkv, int Dk, int Dv,
                 int pt, int M, int S, int pps, int rows, int epl, int vec,
                 float scale, void* stream) {
  if (B <= 0 || tq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Dk <= 0 ||
      Dv <= 0 || pt <= 0 || M <= 0 || S <= 0 || pps <= 0 ||
      pps > kMaxSplitPages || (S - 1) * pps >= M || S * pps < M ||
      32 * epl < (Dk > Dv ? Dk : Dv) || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), kp, vp,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(table), static_cast<const int*>(lens),
         static_cast<float*>(acc), static_cast<float*>(m),
         static_cast<float*>(l), tq, H, Hkv, Dk, Dv, pt, M, pps, S, vec,
         scale};
  if (pool_type >= kI8 && (a.ks == nullptr || a.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pool_type) {
    case kF32: return launch<kF32>(variant, a, B, rows, epl, st);
    case kBF16: return launch<kBF16>(variant, a, B, rows, epl, st);
    case kI8: return launch<kI8>(variant, a, B, rows, epl, st);
    case kE4M3: return launch<kE4M3>(variant, a, B, rows, epl, st);
    case kE5M2: return launch<kE5M2>(variant, a, B, rows, epl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out_type: 0 f32, 1 bf16.  acc (B, H, S, tq, Dv), m, l (B, H, S, tq) ->
// out (B, tq, H * Dv).
int paged_combine(int out_type, const void* acc, const void* m,
                  const void* l, void* out, int B, int tq, int H, int S,
                  int Dv, void* stream) {
  if (B <= 0 || tq <= 0 || H <= 0 || S <= 0 || Dv <= 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(tq, H, B);
  const int bytes = 3 * S * 4;
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  const float* ap = static_cast<const float*>(acc);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  if (out_type == 0)
    paged_combine_kernel<float><<<grid, kCombineThreads, bytes, st>>>(
        ap, mp, lp, static_cast<float*>(out), tq, H, S, Dv);
  else if (out_type == 1)
    paged_combine_kernel<ft::bf16><<<grid, kCombineThreads, bytes, st>>>(
        ap, mp, lp, static_cast<ft::bf16*>(out), tq, H, S, Dv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
