// Kernel B4: fused BatchNorm-apply -> [ReLU] -> 1x1 convolution (a
// matmul) (+ residual), with the per-column sum and sum of squares of the
// f32 accumulator (the next BatchNorm's statistics).
//
//   a[m, k]   = [relu](x[m, k] * scale[k] + shift[k]), rounded to bf16
//   acc[m, n] = sum_k a[m, k] * W[k, n]  (f32)  (+ residual[m, n])
//   y[m, n]   = bf16(acc[m, n])
//   ysum[n]   = sum_m acc[m, n],  ysumsq[n] = sum_m acc[m, n]^2
//
// Replaces the TPU kernels benchmarks/proto_fused.py `_fused_kernel`
// (launched by `fused_bn_matmul`) and benchmarks/proto_sweep.py `kern`
// (launched by `fused`: ReLU on, no residual, the statistics optional).
// x is (M, K) bf16, W (K, N) bf16 row-major (the prototypes' layout,
// contracted in place), scale / shift (K,) f32, the residual (M, N)
// bf16.  The statistics are those of the accumulator after the residual
// add, not of the rounded y (kernel A's are of the stored y).
//
// What bounds it on an H100.  At ResNet-50's batch-256 stage shapes each
// case is 26.3 GFLOP, 0.027 ms on the tensor cores, against 66-925 MB of
// x, W, y and residual, 0.02-0.28 ms at 3.35 TB/s: device memory bounds
// every case but the K = 2048 sweep shape.  So x is read once wherever N
// fits one tile (N <= 256), the activation never reaches device memory,
// and the statistics cost one (row groups, N) partial per column.
//
// Design.  mma.sync.m16n8k16 (bf16, f32 accumulate) on fused_tiles.cuh's
// MMA engine: x goes through the prologue on its way into shared memory
// (cooked once per block), W is read K-major by ldmatrix.trans, a ring of
// four 32-deep cp.async stages.  The grid is (N / BN column blocks) x
// (row groups); each block walks the row tiles t = blockIdx.y, +
// gridDim.y, ..., the counterpart of the TPU grid's innermost sequential
// row axis, keeping its column partials in registers across them.  A
// block's partials are reduced in a fixed order (shuffles over a warp's
// row groups, then the warps in turn) into the (2, row groups, N)
// workspace, and a second kernel sums the row groups in order: no
// atomics, so two launches agree bit for bit.  Tile variants (BM x BN):
// 128x64, 128x128, 128x256, 256x128; ops/fused_bn.py picks the narrowest
// that covers N and sizes the row groups to fill the card.
//
// Any M; K and N multiples of 8 with 16-byte-aligned x, W, y and
// residual (the 16-byte copies and the paired bf16 stores); ops/
// fused_bn.py refuses anything else before a launch, and this entry
// returns cudaErrorInvalidValue for it.
#include "fused_tiles.cuh"

namespace {

using ft::bf16;

// variant codes, as ops/fused_bn.py VARIANTS
enum { V_128x64 = 0, V_128x128, V_128x256, V_256x128 };

template <int BM_, int BN_, int WM_, int WN_, int MIN_>
struct Tile : ft::MmaCfg<BM_, BN_, WM_, WN_> {
  static constexpr int MIN_BLOCKS = MIN_;  // blocks an SM the tile aims at
};
typedef Tile<128, 64, 4, 2, 2> T128x64;    // 8 warps of 32 x 32
typedef Tile<128, 128, 2, 4, 2> T128x128;  // 8 warps of 64 x 32
typedef Tile<128, 256, 2, 4, 1> T128x256;  // 8 warps of 64 x 64
typedef Tile<256, 128, 4, 2, 1> T256x128;  // 8 warps of 64 x 64

template <class C>
struct Bn {
  // x [m][k], through the prologue; W [k][n], as stored
  typedef ft::MmaOperand<C::BM, C::NT, true, true> OA;
  typedef ft::MmaOperand<C::BN, C::NT, false, false> OB;
  // + the warps' column partials, sums and squares: [2][WM][BN]
  typedef ft::MmaSmem<OA, OB, 2 * C::WM * C::BN> Smem;
};

// part: (2, gridDim.y, N) f32, sums then squares, or null (no
// statistics); res may be null
template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
bn_matmul_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, const bf16* __restrict__ w,
                 const bf16* __restrict__ res, bf16* __restrict__ y,
                 float* __restrict__ part, int M, int K, int N, int relu) {
  typedef typename Bn<C>::OA OA;
  typedef typename Bn<C>::OB OB;
  extern __shared__ __align__(128) unsigned char smem[];
  const typename Bn<C>::Smem sm(smem);
  const int n0 = blockIdx.x * C::BN;
  const int tiles = (M + C::BM - 1) / C::BM;
  OA a(x, K, M, K, scale, shift, relu, sm.tab_a);
  OB b(w, N, N, K, nullptr, nullptr, 0, sm.tab_b);

  // this thread's columns ft::mma_col(nt, 0 / 1), summed over its rows
  // of every tile the block walks
  float ps[C::NT8][2], pq[C::NT8][2];
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt)
    ps[nt][0] = ps[nt][1] = pq[nt][0] = pq[nt][1] = 0.f;

  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int m0 = t * C::BM;
    float acc[C::MT][C::NT8][4];
    ft::mma_mainloop<C, OA, OB, true, false>(a, b, m0, n0, 0, K, sm, acc);
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
          const size_t at = (size_t)gm * N + gn;
          if (res) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + at));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(y + at) =
              __floats2bfloat162_rn(v0, v1);
          ps[nt][0] += v0;
          ps[nt][1] += v1;
          pq[nt][0] = fmaf(v0, v0, pq[nt][0]);
          pq[nt][1] = fmaf(v1, v1, pq[nt][1]);
        }
    // the next tile's first copies refill ring slots this tile's last
    // stages were read from
    __syncthreads();
  }
  if (part == nullptr) return;

  // the block's column partials in a fixed order: over a warp's 8 row
  // groups by shuffles, then over the WM warps sharing a column, in turn
  float* red = sm.extra;
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / C::WN;
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = ps[nt][h], q = pq[nt][h];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (lane < 4) {
        const int col = ft::mma_col<C>(nt, h);
        red[wm * C::BN + col] = s;
        red[(C::WM + wm) * C::BN + col] = q;
      }
    }
  __syncthreads();
  const size_t plane = (size_t)gridDim.y * N;
  for (int i = threadIdx.x; i < C::BN; i += C::NT) {
    if (n0 + i >= N) break;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < C::WM; ++r) {
      s += red[r * C::BN + i];
      q += red[(C::WM + r) * C::BN + i];
    }
    const size_t at = (size_t)blockIdx.y * N + n0 + i;
    part[at] = s;
    part[plane + at] = q;
  }
}

// ysum[n] / ysumsq[n]: the R row groups' partials of column n, in order
__global__ void bn_stats_combine(const float* __restrict__ part, int R, int N,
                                 float* __restrict__ ysum,
                                 float* __restrict__ ysumsq) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t plane = (size_t)R * N;
  float s = 0.f, q = 0.f;
  for (int r = 0; r < R; ++r) {
    s += part[(size_t)r * N + n];
    q += part[plane + (size_t)r * N + n];
  }
  ysum[n] = s;
  ysumsq[n] = q;
}

// the dynamic shared memory opt-in, once a tile
template <class C>
cudaError_t prepare() {
  static const cudaError_t attr =
      ft::allow_smem(bn_matmul_kernel<C>, Bn<C>::Smem::BYTES);
  return attr;
}

template <class C>
cudaError_t occupancy(int* blocks) {
  const cudaError_t e = prepare<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bn_matmul_kernel<C>, C::NT, Bn<C>::Smem::BYTES);
}

struct Args {
  const bf16* x;
  const float* scale;
  const float* shift;
  const bf16* w;
  const bf16* res;
  bf16* y;
  float* part;
  float* ysum;
  float* ysumsq;
  int M, K, N, relu, rows;
};

template <class C>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t e = prepare<C>();
  if (e != cudaSuccess) return e;
  const dim3 g((a.N + C::BN - 1) / C::BN, a.rows);
  bn_matmul_kernel<C><<<g, C::NT, Bn<C>::Smem::BYTES, s>>>(
      a.x, a.scale, a.shift, a.w, a.res, a.y, a.part, a.M, a.K, a.N, a.relu);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.part == nullptr) return e;
  bn_stats_combine<<<(a.N + 255) / 256, 256, 0, s>>>(a.part, a.rows, a.N,
                                                    a.ysum, a.ysumsq);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x, w, res, y: bf16; scale, shift: f32 (K,); res may be null.  part: an
// f32 (2, rows, N) workspace, or null to write no statistics (ysum and
// ysumsq are then not touched).  variant: a code of ops/fused_bn.py
// VARIANTS; rows: the row groups (gridDim.y), 1-65535.  Returns the CUDA
// error of the launches (0 = cudaSuccess).
int fused_bn_matmul(const void* x, const void* scale, const void* shift,
                    const void* w, const void* res, void* y, void* part,
                    void* ysum, void* ysumsq, int M, int K, int N, int relu,
                    int variant, int rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 || rows < 1 ||
      rows > 65535 || !aligned16(x) || !aligned16(w) || !aligned16(res) ||
      !aligned16(y) || (part != nullptr && (ysum == nullptr ||
                                            ysumsq == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {static_cast<const bf16*>(x),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(shift),
                  static_cast<const bf16*>(w),
                  static_cast<const bf16*>(res),
                  static_cast<bf16*>(y),
                  static_cast<float*>(part),
                  static_cast<float*>(ysum),
                  static_cast<float*>(ysumsq),
                  M, K, N, relu, rows};
  switch (variant) {
    case V_128x64:
      return (int)launch<T128x64>(a, s);
    case V_128x128:
      return (int)launch<T128x128>(a, s);
    case V_128x256:
      return (int)launch<T128x256>(a, s);
    case V_256x128:
      return (int)launch<T256x128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *blocks: the blocks of a variant's kernel one SM holds at once (its
// shared memory and registers), for sizing the row groups
int fused_bn_occupancy(int variant, int* blocks) {
  switch (variant) {
    case V_128x64:
      return (int)occupancy<T128x64>(blocks);
    case V_128x128:
      return (int)occupancy<T128x128>(blocks);
    case V_128x256:
      return (int)occupancy<T128x256>(blocks);
    case V_256x128:
      return (int)occupancy<T256x128>(blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
