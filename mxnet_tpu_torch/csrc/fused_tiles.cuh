// The tile engines shared by kernel A (fused_fwd.cu) and kernel F
// (fused_bwd.cu).  Each product they compute,
//
//   A      y  = a(x) . W^T   contraction over K   (x: [m][k], W: [n][k])
//   F dx   dz = dy . W       contraction over N   (dy: [m][n], W: [n][k])
//   F dW   dW = dy^T . a(x)  contraction over M   (dy: [m][n], x: [m][k])
//   a(x)   = [relu](x * scale + shift), cast to x's dtype (the prologue)
//
// is one mainloop over the contraction with both operands stored
// contraction-major ("k-major") in shared memory, read from device memory
// along their contiguous dimension (coalesced), so no transpose is ever
// materialised.  An operand whose contiguous dimension is the contraction
// (x and W in A, dy in F's dx) is transposed on its way into shared
// memory; one whose contiguous dimension is the output index (W in F's
// dx, dy and x in F's dW) is stored as it is.  The prologue is applied in
// registers on the way to shared memory, indexed by the contiguous
// dimension (k in both uses), so each x element is transformed once per
// block and the activation never reaches device memory.  Padded positions
// of a prologue operand are 0 after the prologue: relu(0 * scale + shift)
// is not 0, and an unloaded shift may be anything.
//
// Three engines:
//
// * SIMT (f32 CUDA cores; any dtype, widened): BM x BN block tiles, BK
//   deep, a 16 x 16 (or 8 x 8) thread grid, each thread owning TM x TN
//   outputs as 4 x 4 sub-tiles BM / (TM / 4) rows apart, so its shared-
//   memory reads are float4s that a warp serves without conflicts.
//   Double-buffered: the next stage's global loads (16-byte where the
//   shape and pointers allow it, else scalar) go into registers before
//   the current stage's multiply-adds and into the other buffer after
//   them, one barrier a stage.
// * MMA (bf16 tensor cores, f32 accumulate): mma.sync.m16n8k16 fed by
//   ldmatrix (.trans for output-major operands) from padded, conflict-free
//   shared memory, 32 deep; a ring of four stages in flight by cp.async,
//   the prologue operand cooked from its raw stage into a double buffer
//   one stage ahead of its use.  Kernel F's bf16 products and kernel A
//   at the serve's chunks run on it.
// * WGMMA (bf16, sm_90a; kernel A at a training batch): wgmma.mma_async
//   with A from registers, built through the prologue by the thread that
//   owns each fragment, and B (W) by descriptor from 128-byte-swizzled
//   shared memory filled by cp.async (TMA and a producer warp are the
//   next step); the kernel lives in fused_fwd.cu, its building blocks
//   here.
//
// The prologue's scale and shift are read from shared memory (ProTable),
// never from device memory inside the mainloop.
//
// Kernels C and E (flash_attention.cu) use simt_stage for C's f32 P.V
// and the WGMMA building blocks for their bf16 products, with two more:
// MN-major operands (wg_desc_sw128_mn, the instruction's transpose bit)
// and the SS form (A by descriptor too).
//
// Every edge in every dimension is masked, so any shape is taken.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ft {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// x * scale + shift rounded after the multiply and after the add, as the
// plain version's two torch ops round it: an FMA rounds once, and in bf16
// the activation's rounding then flips for some elements
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// the prologue: the matmul operand a(x), as a value of x's dtype
template <typename T>
__device__ __forceinline__ float act(float x, float scale, float shift,
                                     int relu) {
  float a = affine(x, scale, shift);
  if (relu) a = fmaxf(a, 0.f);
  return to_f32(from_f32<T>(a));
}

// four consecutive elements as f32 in one 16-byte (f32) or 8-byte (bf16)
// load; p must be aligned to that width
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
template <>
__device__ __forceinline__ void load4<bf16>(const bf16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies to shared memory, zero-filled when
// !ok (src is then never read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The prologue's scale and shift come from shared memory.  Where the
// prologue index is the contraction (x in A) each stage needs a new slice
// of BK values, copied by cp.async ahead of its use into one of NSLOT
// slots (slot = stage index mod NSLOT).  Where it is the output index (x
// in F's dW) the block's R values are loaded once.
template <int BK, int R, bool SLICES, int NSLOT>
struct ProTable {
  static constexpr int SIZE = SLICES ? NSLOT * 2 * BK : 2 * R;
  // the slice of stage idx: scale at [0, BK), shift at [BK, 2 BK)
  __device__ __forceinline__ static float* slot(float* tab, int idx) {
    return tab + (idx % NSLOT) * 2 * BK;
  }
  // copy the slice of stage idx, contraction [k, k + BK)
  __device__ __forceinline__ static void issue(float* tab, const float* scale,
                                               const float* shift, int idx,
                                               int k, int kend, int tid) {
    if (tid < 2 * BK) {
      const int kk = tid % BK;
      const bool ok = k + kk < kend;
      cp_async4(slot(tab, idx) + tid,
                ok ? (tid < BK ? scale : shift) + k + kk : scale, ok);
    }
  }
  __device__ __forceinline__ static void load(float* tab, const float* scale,
                                              const float* shift, int r0,
                                              int rows, int tid, int nt) {
    for (int i = tid; i < R; i += nt) {
      const bool ok = r0 + i < rows;
      tab[i] = ok ? __ldg(scale + r0 + i) : 0.f;
      tab[R + i] = ok ? __ldg(shift + r0 + i) : 0.f;
    }
  }
};

// ---------------------------------------------------------------------------
// SIMT engine
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct SimtCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int NTX = BN / TN, NTY = BM / TM;  // thread grid
  static constexpr int NT = NTX * NTY;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4 x 4 sub-tiles");
  static_assert(NTX <= 32 && 32 % NTX == 0, "a warp spans whole rows");
};
typedef SimtCfg<128, 128, 8, 8, 8> Simt128;  // 256 threads, 8 x 8 each
typedef SimtCfg<64, 64, 16, 4, 4> Simt64;     // 256 threads, 4 x 4 each
typedef SimtCfg<32, 32, 16, 4, 4> Simt32;     // 64 threads, 4 x 4 each

// output row / column of a thread's accumulator i / j within the tile
template <class C>
__device__ __forceinline__ int simt_row(int i, int ty) {
  return (i / 4) * C::NTY * 4 + ty * 4 + (i % 4);
}
template <class C>
__device__ __forceinline__ int simt_col(int j, int tx) {
  return (j / 4) * C::NTX * 4 + tx * 4 + (j % 4);
}

// One operand tile: R output indices x BK contraction indices, stored as
// s[kk * R + r].  CONTIG_K: the contraction index is contiguous in memory
// (element (r, k) at p[r * ld + k]); else the output index is (element
// (r, k) at p[k * ld + r]).  rows bounds the output index, kend the
// contraction index.  PRO applies the prologue, indexed by the contiguous
// index.  VEC: 4-element loads; needs ld and the contiguous extent
// multiples of 4 and p aligned to the load width.
template <typename T, int R, int BK, int NT, bool CONTIG_K, bool PRO,
          bool VEC>
struct SimtOperand {
  static constexpr int GROUPS = R * BK / 4;  // 4-element groups a tile
  static constexpr int PER = (GROUPS + NT - 1) / NT;
  // three slots: a stage's slice is copied a stage ahead of its put
  typedef ProTable<BK, R, CONTIG_K, 3> Tab;
  static constexpr int TAB = PRO ? Tab::SIZE : 1;  // floats of shared memory
  const T* p;
  long ld;
  int rows, kend;
  const float* scale;
  const float* shift;
  int relu;
  float* tab;
  int r0, k0;
  float v[PER][4];

  __device__ __forceinline__ SimtOperand(const T* p_, long ld_, int rows_,
                                         int kend_, const float* scale_,
                                         const float* shift_, int relu_,
                                         float* tab_)
      : p(p_), ld(ld_), rows(rows_), kend(kend_), scale(scale_),
        shift(shift_), relu(relu_), tab(tab_), r0(0), k0(0) {}

  // before the mainloop's first barrier: the first two slices, or the
  // table
  __device__ __forceinline__ void begin(int r0_, int kbeg, int tid) {
    if (!PRO) return;
    if (CONTIG_K) {
      Tab::issue(tab, scale, shift, kbeg / BK, kbeg, kend, tid);
      Tab::issue(tab, scale, shift, kbeg / BK + 1, kbeg + BK, kend, tid);
    } else {
      Tab::load(tab, scale, shift, r0_, rows, tid, NT);
    }
  }

  // group g's first element: output r, contraction k (within the tile)
  __device__ __forceinline__ static void coords(int g, int& r, int& k) {
    if (CONTIG_K) {
      r = g / (BK / 4);
      k = (g % (BK / 4)) * 4;
    } else {
      k = g / (R / 4);
      r = (g % (R / 4)) * 4;
    }
  }

  // element e of a group lies in bounds
  __device__ __forceinline__ bool inside(int gr, int gk, int e) const {
    return CONTIG_K ? (gr < rows && gk + e < kend)
                    : (gk < kend && gr + e < rows);
  }

  // device memory -> registers (raw values, masked to 0)
  __device__ __forceinline__ void fetch(int r0_, int k0_, int tid) {
    r0 = r0_;
    k0 = k0_;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int g = tid + j * NT;
      if (GROUPS % NT != 0 && g >= GROUPS) break;
      int r, k;
      coords(g, r, k);
      const int gr = r0 + r, gk = k0 + k;
      const T* q = CONTIG_K ? p + gr * ld + gk : p + (long)gk * ld + gr;
      if (VEC && inside(gr, gk, 3)) {
        // the contiguous extent is a multiple of 4: all four or none
        load4<T>(q, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[j][e] = inside(gr, gk, e) ? to_f32(q[e]) : 0.f;
      }
    }
    // the slice two stages on: a whole stage of slack before its put
    if (PRO && CONTIG_K)
      Tab::issue(tab, scale, shift, k0 / BK + 2, k0 + 2 * BK, kend, tid);
  }

  // registers -> shared memory, through the prologue
  __device__ __forceinline__ void put(float* s, int tid) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int g = tid + j * NT;
      if (GROUPS % NT != 0 && g >= GROUPS) break;
      int r, k;
      coords(g, r, k);
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = v[j][e];
      if (PRO) {
        const float* t = CONTIG_K ? Tab::slot(tab, k0 / BK) + k : tab + r;
        const float4 sc = *reinterpret_cast<const float4*>(t);
        const float4 sh =
            *reinterpret_cast<const float4*>(t + (CONTIG_K ? BK : R));
        const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
        const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
        // Padded prologue indices read scale = shift = 0 from the table
        // and x = 0, so a = 0 there.  Padded output rows (x in A) give
        // rows that are never stored.  A padded contraction index (x in
        // F's dW: rows past M) must be 0: relu(shift) times a zero dy
        // row is NaN where shift is not finite.
        const bool live = CONTIG_K || k0 + k < kend;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = live ? act<T>(a[e], scv[e], shv[e], relu) : 0.f;
      }
      if (CONTIG_K) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[(k + e) * R + r] = a[e];
      } else {
        *reinterpret_cast<float4*>(s + k * R + r) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
};

// acc += As^T Bs over one BK-deep stage (As[kk][BM], Bs[kk][BN])
template <class C>
__device__ __forceinline__ void simt_stage(const float* As, const float* Bs,
                                           float (&acc)[C::TM][C::TN],
                                           int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < C::BK; ++kk) {
    float a[C::TM], b[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM / 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(
          As + kk * C::BM + i * C::NTY * 4 + ty * 4);
      a[4 * i] = t.x, a[4 * i + 1] = t.y, a[4 * i + 2] = t.z,
      a[4 * i + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < C::TN / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(
          Bs + kk * C::BN + j * C::NTX * 4 + tx * 4);
      b[4 * j] = t.x, b[4 * j + 1] = t.y, b[4 * j + 2] = t.z,
      b[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The double-buffered mainloop over contraction [kbeg, kend): As holds
// 2 * BK * BM floats, Bs 2 * BK * BN.  The next stage's global loads go
// into registers before the current stage's multiply-adds and through
// the prologue into the other buffer after them, one barrier a stage.
// Starts and ends with a barrier, so shared memory written before the
// call is visible to every thread after it.
template <class C, class OA, class OB>
__device__ __forceinline__ void simt_mainloop(OA& a, OB& b, int r0, int c0,
                                              int kbeg, int kend, float* As,
                                              float* Bs,
                                              float (&acc)[C::TM][C::TN]) {
  constexpr int SA = C::BK * C::BM, SB = C::BK * C::BN;  // a stage
  const int tid = threadIdx.x;
  const int ty = tid / C::NTX, tx = tid % C::NTX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  a.begin(r0, kbeg, tid);
  b.begin(c0, kbeg, tid);
  cp_async_wait_all();
  __syncthreads();
  if (kbeg >= kend) return;
  a.fetch(r0, kbeg, tid);
  b.fetch(c0, kbeg, tid);
  cp_async_commit();
  a.put(As, tid);
  b.put(Bs, tid);
  cp_async_wait_group<1>();  // all but the slices issued last
  __syncthreads();
  const int nst = (kend - kbeg + C::BK - 1) / C::BK;
  for (int st = 0; st < nst; ++st) {
    const int k0 = kbeg + st * C::BK;
    const bool more = st + 1 < nst;
    if (more) {
      a.fetch(r0, k0 + C::BK, tid);
      b.fetch(c0, k0 + C::BK, tid);
    }
    cp_async_commit();
    simt_stage<C>(As + (st & 1) * SA, Bs + (st & 1) * SB, acc, ty, tx);
    if (more) {
      a.put(As + ((st + 1) & 1) * SA, tid);
      b.put(Bs + ((st + 1) & 1) * SB, tid);
    }
    cp_async_wait_group<1>();
    __syncthreads();
  }
  cp_async_wait_all();
}

// Adds a thread's per-column partial p[j] into the tile's shared column
// sums col[BN]: a shuffle over the threads of a warp that share a column,
// then one shared atomic per warp and column.
template <class C>
__device__ __forceinline__ void simt_col_add(const float (&p)[C::TN],
                                             float* col, int tx) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < C::TN; ++j) {
    float v = p[j];
#pragma unroll
    for (int o = C::NTX; o < 32; o <<= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane < C::NTX) atomicAdd(&col[simt_col<C>(j, tx)], v);
  }
}

// ---------------------------------------------------------------------------
// MMA engine (bf16)
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WM_, int WN_>
struct MmaCfg {
  static constexpr int BM = BM_, BN = BN_, BK = 32, WM = WM_, WN = WN_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  static constexpr int MT = WTM / 16, NT8 = WTN / 8;  // mma tiles a warp
  static_assert(NT8 % 2 == 0, "B fragments load two n8 tiles at once");
};
typedef MmaCfg<128, 128, 2, 4> Mma128;  // 8 warps of 64 x 32
typedef MmaCfg<64, 64, 2, 2> Mma64;     // 4 warps of 32 x 32

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {lo, hi} rounded to bf16 with negatives clamped to 0, one instruction
__device__ __forceinline__ __nv_bfloat162 pack_relu(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

constexpr int MMA_STAGES = 4;  // the ring of raw tiles in shared memory

// One bf16 operand tile: R output indices x 32 contraction indices.
// KMAJ (the contraction contiguous in memory, element (r, k) at
// p[r * ld + k]) is stored s[r][k] with rows of 40; otherwise (element
// (r, k) at p[k * ld + r]) s[k][r] with rows of R + 8.  The padding puts
// the 8 rows an ldmatrix reads on distinct banks.  Loads are 16-byte
// cp.async chunks of 8 elements along the contiguous dimension (zero-
// filled out of bounds), which needs ld and the contiguous extent
// multiples of 8 and p 16-byte aligned.  With PRO the raw chunks are
// then "cooked" into a second buffer of the same layout: read back,
// passed through the prologue (indexed by the contiguous index, its
// scale / shift from a ProTable), rounded to bf16 and stored.
template <int R, int NT, bool KMAJ, bool PRO>
struct MmaOperand {
  static constexpr int LDS = KMAJ ? 40 : R + 8;
  static constexpr int SIZE = KMAJ ? R * 40 : 32 * (R + 8);  // elements
  static constexpr int CHUNKS = R * 32 / 8;
  static constexpr int PER = CHUNKS / NT;
  static_assert(CHUNKS % NT == 0, "whole chunks per thread");
  static constexpr bool IS_PRO = PRO;
  // a slice per stage in the ring
  typedef ProTable<32, R, KMAJ, MMA_STAGES> Tab;
  static constexpr int TAB = PRO ? Tab::SIZE : 0;  // floats of shared memory
  const bf16* p;
  long ld;
  int rows, kend;
  const float* scale;
  const float* shift;
  int relu;
  float* tab;

  __device__ __forceinline__ MmaOperand(const bf16* p_, long ld_, int rows_,
                                        int kend_, const float* scale_,
                                        const float* shift_, int relu_,
                                        float* tab_)
      : p(p_), ld(ld_), rows(rows_), kend(kend_), scale(scale_),
        shift(shift_), relu(relu_), tab(tab_) {}

  __device__ __forceinline__ static void coords(int c, int& r, int& k) {
    if (KMAJ) {
      r = c / 4;
      k = (c % 4) * 8;
    } else {
      k = c / (R / 8);
      r = (c % (R / 8)) * 8;
    }
  }
  __device__ __forceinline__ static int soff(int r, int k) {
    return KMAJ ? r * LDS + k : k * LDS + r;
  }

  // before the mainloop's first barrier: the block's table
  __device__ __forceinline__ void begin(int r0, int tid) {
    if (PRO && !KMAJ) Tab::load(tab, scale, shift, r0, rows, tid, NT);
  }

  // stage t (contraction [k0, k0 + 32)) into a raw ring slot, with its
  // prologue slice
  __device__ __forceinline__ void fetch(bf16* raw, int r0, int k0, int t,
                                        int tid) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int r, k;
      coords(tid + j * NT, r, k);
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < kend;
      const bf16* q = ok ? (KMAJ ? p + gr * ld + gk : p + (long)gk * ld + gr)
                         : p;
      cp_async16(raw + soff(r, k), q, ok);
    }
    if (PRO && KMAJ) Tab::issue(tab, scale, shift, t, k0, kend, tid);
  }

  // the prologue over stage t's raw tile into the cooked buffer; padded
  // positions are 0.  A thread's chunks share their 8 prologue indices
  // (KMAJ: the same k, since NT is a multiple of 4; otherwise the same
  // r, since NT is a multiple of R / 8), so it reads their scale and
  // shift once.
  __device__ __forceinline__ void cook(const bf16* raw, bf16* cooked, int r0,
                                       int k0, int t, int tid) {
    static_assert(KMAJ ? NT % 4 == 0 : NT % (R / 8) == 0, "shared indices");
    int r, k;
    coords(tid, r, k);
    const float* tb = KMAJ ? Tab::slot(tab, t) + k : tab + r;
    const int to_shift = KMAJ ? 32 : R;
    float sc[8], sh[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 s4 = *reinterpret_cast<const float4*>(tb + 4 * h);
      const float4 h4 = *reinterpret_cast<const float4*>(tb + to_shift + 4 * h);
      sc[4 * h] = s4.x, sc[4 * h + 1] = s4.y, sc[4 * h + 2] = s4.z,
      sc[4 * h + 3] = s4.w;
      sh[4 * h] = h4.x, sh[4 * h + 1] = h4.y, sh[4 * h + 2] = h4.z,
      sh[4 * h + 3] = h4.w;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      coords(tid + j * NT, r, k);
      const int gr = r0 + r, gk = k0 + k;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (gr < rows && gk < kend) {
        const uint4 in4 = *reinterpret_cast<const uint4*>(raw + soff(r, k));
        const __nv_bfloat162* in =
            reinterpret_cast<const __nv_bfloat162*>(&in4);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = __bfloat1622float2(in[e]);
          const float a0 = affine(xv.x, sc[2 * e], sh[2 * e]);
          const float a1 = affine(xv.y, sc[2 * e + 1], sh[2 * e + 1]);
          // act<bf16>'s one rounding, two elements at a time; the ReLU
          // rides on the conversion (relu then round = round then relu)
          o[e] = relu ? pack_relu(a0, a1) : __floats2bfloat162_rn(a0, a1);
        }
      }
      *reinterpret_cast<uint4*>(cooked + soff(r, k)) = out;
    }
  }
};

// acc += A . B over one 32-deep stage: warp (wm, wn) owns the WTM x WTN
// sub-tile; A fragments by ldmatrix (.trans when A is stored k-rows), B
// fragments two n8 tiles per ldmatrix.
template <class C, bool AK, bool BK_>
__device__ __forceinline__ void mma_stage(const bf16* sA, const bf16* sB,
                                          float (&acc)[C::MT][C::NT8][4],
                                          int wm, int wn, int lane) {
  constexpr int LDA = AK ? 40 : C::BM + 8;
  constexpr int LDB = BK_ ? 40 : C::BN + 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int kk = ks * 16;
    uint32_t af[C::MT][4];
    uint32_t bfr[C::NT8][2];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int m0 = wm * C::WTM + mt * 16;
      if (AK) {
        ldsm_x4(af[mt], sA + (m0 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
      } else {
        const int q = lane >> 3, r = lane & 7;
        ldsm_x4_t(af[mt],
                  sA + (kk + r + (q >> 1) * 8) * LDA + m0 + (q & 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < C::NT8 / 2; ++np) {
      const int n0 = wn * C::WTN + np * 16;
      const int q = lane >> 3, r = lane & 7;
      uint32_t t[4];
      if (BK_) {
        ldsm_x4(t, sB + (n0 + r + (q >> 1) * 8) * LDB + kk + (q & 1) * 8);
      } else {
        ldsm_x4_t(t, sB + (kk + r + (q & 1) * 8) * LDB + n0 + (q >> 1) * 8);
      }
      bfr[2 * np][0] = t[0];
      bfr[2 * np][1] = t[1];
      bfr[2 * np + 1][0] = t[2];
      bfr[2 * np + 1][1] = t[3];
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT8; ++nt)
        mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
  }
}

// The dynamic shared memory of an MMA kernel: the raw rings of both
// operands, the cooked double buffer of the prologue operand, the
// prologue's table and `extra` floats for the epilogue.
template <class OA, class OB, int EXTRA>
struct MmaSmem {
  static constexpr int RAW_A = MMA_STAGES * OA::SIZE;
  static constexpr int RAW_B = MMA_STAGES * OB::SIZE;
  static constexpr int COOK =
      OA::IS_PRO ? 2 * OA::SIZE : OB::IS_PRO ? 2 * OB::SIZE : 0;
  static constexpr int TAB = OA::TAB + OB::TAB;
  static constexpr int BYTES =
      (RAW_A + RAW_B + COOK) * 2 + (TAB + EXTRA) * 4;
  static_assert((RAW_A + RAW_B + COOK) * 2 % 16 == 0, "float4 alignment");
  bf16* raw_a;
  bf16* raw_b;
  bf16* cook;
  float* tab_a;
  float* tab_b;
  float* extra;
  __device__ __forceinline__ explicit MmaSmem(unsigned char* base) {
    raw_a = reinterpret_cast<bf16*>(base);
    raw_b = raw_a + RAW_A;
    cook = raw_b + RAW_B;
    tab_a = reinterpret_cast<float*>(cook + COOK);
    tab_b = tab_a + OA::TAB;
    extra = tab_b + OB::TAB;
  }
};

// The mainloop over contraction [kbeg, kend) in 32-deep stages: a ring of
// MMA_STAGES raw stages in flight by cp.async, one barrier a stage.  At
// stage s the ring already holds s + 1 .. s + MMA_STAGES - 2; the copy
// of stage s + MMA_STAGES - 1 is issued into the slot stage s - 1 left,
// stage s is multiplied and the prologue operand's stage s + 1 cooked.
// Starts with a barrier, so shared memory written before the call is
// visible after it.
template <class C, class OA, class OB, bool AK, bool BK_, class SM>
__device__ __forceinline__ void mma_mainloop(OA& a, OB& b, int r0, int c0,
                                             int kbeg, int kend, const SM& sm,
                                             float (&acc)[C::MT][C::NT8][4]) {
  constexpr int S = MMA_STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  a.begin(r0, tid);
  b.begin(c0, tid);
  const int nst = (kend - kbeg + C::BK - 1) / C::BK;
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nst) {
      a.fetch(sm.raw_a + t * OA::SIZE, r0, kbeg + t * C::BK, t, tid);
      b.fetch(sm.raw_b + t * OB::SIZE, c0, kbeg + t * C::BK, t, tid);
    }
    cp_async_commit();
  }
  cp_async_wait_group<S - 2>();  // stage 0 has landed
  __syncthreads();
  if (nst <= 0) return;
  if constexpr (OA::IS_PRO) a.cook(sm.raw_a, sm.cook, r0, kbeg, 0, tid);
  if constexpr (OB::IS_PRO) b.cook(sm.raw_b, sm.cook, c0, kbeg, 0, tid);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_group<S - 3>();  // stage s + 1 has landed
    __syncthreads();
    const int t = s + S - 1;
    if (t < nst) {
      a.fetch(sm.raw_a + (t % S) * OA::SIZE, r0, kbeg + t * C::BK, t, tid);
      b.fetch(sm.raw_b + (t % S) * OB::SIZE, c0, kbeg + t * C::BK, t, tid);
    }
    cp_async_commit();
    const bf16* sA = OA::IS_PRO ? sm.cook + (s & 1) * OA::SIZE
                                : sm.raw_a + (s % S) * OA::SIZE;
    const bf16* sB = OB::IS_PRO ? sm.cook + (s & 1) * OB::SIZE
                                : sm.raw_b + (s % S) * OB::SIZE;
    mma_stage<C, AK, BK_>(sA, sB, acc, wm, wn, lane);
    // cooked while the tensor cores run the stage's products
    if (s + 1 < nst) {
      const int k1 = kbeg + (s + 1) * C::BK;
      if constexpr (OA::IS_PRO)
        a.cook(sm.raw_a + ((s + 1) % S) * OA::SIZE,
               sm.cook + ((s + 1) & 1) * OA::SIZE, r0, k1, s + 1, tid);
      if constexpr (OB::IS_PRO)
        b.cook(sm.raw_b + ((s + 1) % S) * OB::SIZE,
               sm.cook + ((s + 1) & 1) * OB::SIZE, c0, k1, s + 1, tid);
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// WGMMA engine (bf16, sm_90a): a warpgroup's 64 x 128 product, A from
// registers, B from 128-byte-swizzled shared memory by descriptor
// ---------------------------------------------------------------------------

// The byte offset of 16-byte chunk c (0..7) of row r in a tile of
// 128-byte rows with the 128-byte swizzle (chunk index XOR row mod 8),
// the layout a SWIZZLE_128B descriptor reads; the tile is 1024-B aligned.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Descriptor of a K-major operand in 128-byte-swizzled rows (64 bf16 of
// the contraction each) starting at shared address `saddr`: 8-row groups
// 1024 bytes apart; the leading offset is unused by swizzled K-major
// layouts.  Advancing the contraction by 16 elements adds 2 (32 bytes).
__device__ __forceinline__ uint64_t wg_desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a register across the asynchronous product: the compiler may not
// move its reads or writes over this point, nor reuse it before
__device__ __forceinline__ void wg_pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void wg_pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x N, f32: the accumulator layout of mma.m16n8k16 repeated over
// N / 8 column blocks of 8) += a (64 x 16 bf16 in registers: each warp's
// 16 rows in mma.m16n8k16's A layout) . B (N x 16 by descriptor)^T;
// specialised for the widths a kernel uses (128)
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_m64k16<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67},"
      " %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));  // scale-d: accumulate into d
}

// Descriptor of an MN-major operand (the output index N or M contiguous,
// the contraction across rows) in 128-byte-swizzled tiles: each 128-byte
// row holds 64 bf16 of the output index for one contraction index, 8
// rows make a 1024-byte swizzle atom, and atoms of the next 8 contraction
// indices follow 1024 bytes on (the stride offset).  An output index wider
// than 64 continues in a second tile `lbo` bytes on (the leading offset).
// Advancing the contraction by 16 adds 2048 bytes to `saddr`.  The
// instruction reads it with its transpose bit set.
__device__ __forceinline__ uint64_t wg_desc_sw128_mn(uint32_t saddr,
                                                     uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Rows [row0, row0 + R) of a row-major (rows, W) bf16 slab into R x W
// 128-byte-swizzled tiles, by 16-byte cp.async chunks (zero-filled past
// `rows`): W / 64 column tiles of R rows x 128 bytes, R * 128 bytes
// apart, chunk c of row r at sw128(r, c) within its tile.  Read K-major
// (the contraction along W) by wg_desc_sw128 on each column tile, or
// MN-major (the contraction along the rows) by wg_desc_sw128_mn with
// lbo = R * 128.  dst is 1024-byte aligned; src 16-byte aligned.
template <int R, int W, int NT>
__device__ __forceinline__ void load_sw128(unsigned char* dst,
                                           const bf16* src, int row0,
                                           int rows, int tid) {
  static_assert(W % 64 == 0 && (R * W / 8) % NT == 0, "whole chunks");
#pragma unroll
  for (int j = 0; j < R * W / 8 / NT; ++j) {
    const int c = tid + j * NT, r = c / (W / 8), ch = c % (W / 8);
    const bool ok = row0 + r < rows;
    cp_async16(dst + (ch >> 3) * R * 128 + sw128(r, ch & 7),
               ok ? src + (size_t)(row0 + r) * W + ch * 8 : src, ok);
  }
}

// The products of kernels C and E (flash_attention.cu), for the widths
// they use.  wgmma_rs<N, TB>: d (64 x N f32) += a (64 x 16 bf16 in
// registers, as for wgmma_m64k16) . B, with B by descriptor: K-major
// (TB = 0, as wg_desc_sw128) or MN-major (TB = 1, wg_desc_sw128_mn).
// wgmma_ss<N>: d += A . B^T with both by K-major descriptor.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      "{%32, %33, %34, %35},"
      " %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      "{%32, %33, %34, %35},"
      " %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      "{%64, %65, %66, %67},"
      " %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Lets a kernel take `bytes` of dynamic shared memory (beyond 48 KB only
// after this opt-in).  Callers keep the result in a function-local static
// of a launcher instantiated per kernel, so it runs once per kernel.
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// tile row / column of accumulator element e of mma tile (mt, nt)
template <class C>
__device__ __forceinline__ int mma_row(int mt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / C::WN) * C::WTM + mt * 16 + (lane >> 2) + (e >> 1) * 8;
}
template <class C>
__device__ __forceinline__ int mma_col(int nt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % C::WN) * C::WTN + nt * 8 + (lane & 3) * 2 + (e & 1);
}

// Adds per-thread column partials p[nt][2] (columns mma_col(nt, 0 / 1))
// into the tile's shared column sums: a shuffle over the 8 row groups of
// a warp, then one shared atomic per warp and column.
template <class C>
__device__ __forceinline__ void mma_col_add(const float (&p)[C::NT8][2],
                                            float* col) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = p[nt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) atomicAdd(&col[mma_col<C>(nt, h)], v);
    }
}

}  // namespace ft
