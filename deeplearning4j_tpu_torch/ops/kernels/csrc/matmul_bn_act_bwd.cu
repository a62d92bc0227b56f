// Fused 1x1-conv + BatchNorm merged backward for Hopper (sm_90a).
//
// For the forward y = act(x * a + b) @ W, s1 = sum_m y, s2 = sum_m y*y
// (matmul_bn_act.cu) and the cotangents dy [M,N], ds1, ds2 [N]:
//
//     dyt  = dy + ds1 + 2*y*ds2             f32, rounded to dy's dtype
//     dxh  = dyt @ W^T                      [M, K]
//     pre  = x*a + b,  xhat = act(pre)      (no prologue: xhat = x)
//     dpre = relu_in ? (pre > 0 ? dxh : 0) : dxh
//     dx   = dpre * a  in x's dtype         (no prologue: dx = dxh)
//     da   = sum_m dpre * x,  db = sum_m dpre            f32 [K]
//     dW   = xhat^T @ dyt, summed in f32, stored in W's dtype  [K, N]
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/conv_bn.py
// (_matmul_bn_bwd -> _bwd_kernel), the backward of every 1x1 conv of a
// ResNet-50 bottleneck.  That kernel walks M in order on one core and
// carries dW, da and db in VMEM from one grid step to the next.  Here
// blocks run in parallel in no order, so the one TPU kernel becomes two:
//
//   * dx kernel, grid (K tiles, M tiles): forms dyt while it loads the dy
//     and y tiles, multiplies by W^T, recomputes pre from the x tile in its
//     epilogue, writes dx, and writes each block's da/db column sums to its
//     own row of a [tiles_m, K] scratch;
//   * dW kernel, grid (N tiles, K tiles, M splits): recomputes xhat and
//     dyt on load and writes each split's product to its own [K, N] slice
//     of a [splits, K, N] f32 scratch.  Splitting M keeps the card's SMs
//     busy (the wrapper reads their count) where K*N has few tiles (res2:
//     K = N = 64, one tile);
//   * a reduce kernel sums each scratch over its rows in a fixed order, so
//     dW, da and db are the same on every run (no atomics).
//
// Rows past M are never loaded: the loaders give zeros there, so they add
// nothing to dW, da or db, and dx is not stored for them.  Any K and N:
// when both are multiples of 32 (every ResNet-50 shape) the loaders move 16
// bytes a thread; otherwise each kernel's RAGGED template loads and stores
// element by element (rows of a ragged K or N need not be 16-byte aligned),
// gives zeros past K and N in every operand, and writes nothing past them.
//
// What bounds it on the H100: twice the forward's operations (4*M*K*N).
// f32 accumulates in full f32 on the CUDA cores (the JAX kernel asks for
// Precision.HIGHEST, so no TF32), 67 TFLOP/s: every ResNet-50 shape is
// bound by operations.  bf16 runs on the tensor cores (WMMA 16x16x16, f32
// accumulate), where most shapes are bound by the bytes of x, y, dy, dx.
// This is the simple first design: 128x128 tiles, no double buffering,
// no wgmma/TMA.
//
// Requirements checked by the Python wrapper: contiguous row-major tensors,
// 16-byte aligned base pointers, M < 65536 * 128, a split length that is a
// multiple of 32.  Every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;

// no FMA contraction anywhere the plain version rounds each step
__device__ __forceinline__ float pre_act(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(v, a), b);
}

__device__ __forceinline__ float xhat_of(float v, float a, float b, int relu_in) {
  const float h = pre_act(v, a, b);
  return (relu_in && !(h > 0.f)) ? 0.f : h;
}

__device__ __forceinline__ float dy_total(float dy, float y, float ds1, float ds2) {
  return __fadd_rn(__fadd_rn(dy, ds1), __fmul_rn(__fmul_rn(2.f, y), ds2));
}

// ------------------------------------------------------------------ f32
constexpr int F_BK = 8;

// The 8x8 register tile of one thread: rows ty*4+{0..3}, 64+ty*4+{0..3} of
// the block's 128 rows, columns likewise with tx, from As[k][row], Bs[k][col].
__device__ __forceinline__ void fma_tile(float (*As)[TILE], float (*Bs)[TILE],
                                         int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < F_BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int i, int t) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// dx tile [128 rows of M] x [128 columns of K], contracting N 8 at a time.
template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
bwd_dx_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ y, const float* __restrict__ dy,
                  const float* __restrict__ ds1, const float* __restrict__ ds2,
                  float* __restrict__ dx, float* __restrict__ part_da,
                  float* __restrict__ part_db, int M, int N, int K,
                  int has_prologue, int relu_in) {
  __shared__ __align__(16) float As[F_BK][TILE];   // dyt, n-major: As[n][m]
  __shared__ __align__(16) float Bs[F_BK][TILE];   // W^T: Bs[n][k] = w[k][n]
  __shared__ float red1[16][TILE];
  __shared__ float red2[16][TILE];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;

  // loaders: 4 consecutive n of one dy/y row and of one W row per step
  const int l_row = tid >> 1, l_n = (tid & 1) * 4;
  const bool a_live = (m0 + l_row) < M;
  const bool b_live = (k0 + l_row) < K;
  const size_t a_off = (size_t)(a_live ? m0 + l_row : 0) * N + l_n;
  const float* wp = w + (size_t)(b_live ? k0 + l_row : 0) * N + l_n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += F_BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (!RAGGED) {
      if (a_live) {
        const float4 d = *reinterpret_cast<const float4*>(dy + a_off + n0);
        const float4 yv = *reinterpret_cast<const float4*>(y + a_off + n0);
        const int n = n0 + l_n;
        av.x = dy_total(d.x, yv.x, ds1[n + 0], ds2[n + 0]);
        av.y = dy_total(d.y, yv.y, ds1[n + 1], ds2[n + 1]);
        av.z = dy_total(d.z, yv.z, ds1[n + 2], ds2[n + 2]);
        av.w = dy_total(d.w, yv.w, ds1[n + 3], ds2[n + 3]);
      }
      if (b_live) bv = *reinterpret_cast<const float4*>(wp + n0);
    } else {
      float* ae = &av.x;
      float* be = &bv.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + l_n + q;
        if (n >= N) continue;
        if (a_live) ae[q] = dy_total(dy[a_off + n0 + q], y[a_off + n0 + q], ds1[n], ds2[n]);
        if (b_live) be[q] = wp[n0 + q];
      }
    }
    As[l_n + 0][l_row] = av.x;
    As[l_n + 1][l_row] = av.y;
    As[l_n + 2][l_row] = av.z;
    As[l_n + 3][l_row] = av.w;
    Bs[l_n + 0][l_row] = bv.x;
    Bs[l_n + 1][l_row] = bv.y;
    Bs[l_n + 2][l_row] = bv.z;
    Bs[l_n + 3][l_row] = bv.w;
    __syncthreads();
    fma_tile(As, Bs, tx, ty, acc);
    __syncthreads();
  }

  // epilogue: dpre from the recomputed pre, dx, and the da/db column sums
  float cda[8], cdb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cda[j] = cdb[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_row(i, ty);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = k0 + h * 64 + tx * 4;
      if (gk >= K) continue;
      float v[4] = {acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]};
      if constexpr (RAGGED) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (gk + q >= K) continue;
          const size_t off = (size_t)gm * K + gk + q;
          if (has_prologue) {
            const float xq = x[off], ak = a[gk + q];
            if (relu_in && !(pre_act(xq, ak, b[gk + q]) > 0.f)) v[q] = 0.f;
            cda[h * 4 + q] += v[q] * xq;
            cdb[h * 4 + q] += v[q];
            v[q] = __fmul_rn(v[q], ak);
          }
          dx[off] = v[q];
        }
        continue;
      }
      if (has_prologue) {
        const float4 xv = *reinterpret_cast<const float4*>(x + (size_t)gm * K + gk);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ak = a[gk + q];
          if (relu_in && !(pre_act(xs[q], ak, b[gk + q]) > 0.f)) v[q] = 0.f;
          cda[h * 4 + q] += v[q] * xs[q];
          cdb[h * 4 + q] += v[q];
          v[q] = __fmul_rn(v[q], ak);
        }
      }
      *reinterpret_cast<float4*>(dx + (size_t)gm * K + gk) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (!has_prologue) return;   // uniform over the block
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_row(j, tx);
    red1[ty][c] = cda[j];
    red2[ty][c] = cdb[j];
  }
  __syncthreads();
  const int c = tid & (TILE - 1);
  if (k0 + c < K) {
    float (*red)[TILE] = tid < TILE ? red1 : red2;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[t][c];
    (tid < TILE ? part_da : part_db)[(size_t)blockIdx.y * K + k0 + c] = s;
  }
}

// dW partial tile [128 rows of K] x [128 columns of N] over the rows
// [split * chunk, (split + 1) * chunk) of M, 8 at a time.
template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
bwd_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ y,
                  const float* __restrict__ dy, const float* __restrict__ ds1,
                  const float* __restrict__ ds2, float* __restrict__ part_dw,
                  int M, int N, int K, int chunk, int has_prologue, int relu_in) {
  __shared__ __align__(16) float As[F_BK][TILE];   // xhat: As[m][k]
  __shared__ __align__(16) float Bs[F_BK][TILE];   // dyt:  Bs[m][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int mbeg = blockIdx.z * chunk;
  const int mend = min(M, mbeg + chunk);

  // loaders: row l_r of the step, 4 consecutive columns l_c of x and of dy/y
  const int l_r = tid >> 5, l_c = (tid & 31) * 4;
  const bool a_live = (k0 + l_c) < K;
  const bool b_live = (n0 + l_c) < N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int mm = mbeg; mm < mend; mm += F_BK) {
    const int gm = mm + l_r;
    const bool row_live = gm < mend;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (RAGGED && row_live) {
      float* ae = &av.x;
      float* be = &bv.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + l_c + q, n = n0 + l_c + q;
        if (k < K) {
          const float v = x[(size_t)gm * K + k];
          ae[q] = has_prologue ? xhat_of(v, a[k], b[k], relu_in) : v;
        }
        if (n < N) {
          const size_t off = (size_t)gm * N + n;
          be[q] = dy_total(dy[off], y[off], ds1[n], ds2[n]);
        }
      }
    }
    if (!RAGGED && row_live && a_live) {
      av = *reinterpret_cast<const float4*>(x + (size_t)gm * K + k0 + l_c);
      if (has_prologue) {
        const int k = k0 + l_c;
        av.x = xhat_of(av.x, a[k + 0], b[k + 0], relu_in);
        av.y = xhat_of(av.y, a[k + 1], b[k + 1], relu_in);
        av.z = xhat_of(av.z, a[k + 2], b[k + 2], relu_in);
        av.w = xhat_of(av.w, a[k + 3], b[k + 3], relu_in);
      }
    }
    *reinterpret_cast<float4*>(&As[l_r][l_c]) = av;
    if (!RAGGED && row_live && b_live) {
      const size_t off = (size_t)gm * N + n0 + l_c;
      const float4 d = *reinterpret_cast<const float4*>(dy + off);
      const float4 yv = *reinterpret_cast<const float4*>(y + off);
      const int n = n0 + l_c;
      bv.x = dy_total(d.x, yv.x, ds1[n + 0], ds2[n + 0]);
      bv.y = dy_total(d.y, yv.y, ds1[n + 1], ds2[n + 1]);
      bv.z = dy_total(d.z, yv.z, ds1[n + 2], ds2[n + 2]);
      bv.w = dy_total(d.w, yv.w, ds1[n + 3], ds2[n + 3]);
    }
    *reinterpret_cast<float4*>(&Bs[l_r][l_c]) = bv;
    __syncthreads();
    fma_tile(As, Bs, tx, ty, acc);
    __syncthreads();
  }

  float* out = part_dw + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gk = k0 + tile_row(i, ty);
    if (gk >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      if constexpr (RAGGED) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gn + q < N) out[(size_t)gk * N + gn + q] = acc[i][h * 4 + q];
      } else if (gn < N) {
        *reinterpret_cast<float4*>(out + (size_t)gk * N + gn) = make_float4(
            acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      }
    }
  }
}

// ----------------------------------------------------------------- bf16
constexpr int H_BK = 32;
constexpr int S_LD = H_BK + 8;     // padded leading dims (multiples of 8)
constexpr int W_LD = TILE + 8;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// 8 bf16 of dy and y -> 8 bf16 of dyt (f32 arithmetic, one rounding)
__device__ __forceinline__ uint4 dyt8(const bf16* dy, const bf16* y, const float* ds1,
                                      const float* ds2, int n) {
  uint4 d = *reinterpret_cast<const uint4*>(dy);
  const uint4 yy = *reinterpret_cast<const uint4*>(y);
  bf162* dh = reinterpret_cast<bf162*>(&d);
  const bf162* yh = reinterpret_cast<const bf162*>(&yy);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 df = __bfloat1622float2(dh[q]);
    const float2 yf = __bfloat1622float2(yh[q]);
    const int c = n + 2 * q;
    dh[q] = __floats2bfloat162_rn(dy_total(df.x, yf.x, ds1[c], ds2[c]),
                                  dy_total(df.y, yf.y, ds1[c + 1], ds2[c + 1]));
  }
  return d;
}

// The same 8 entries, one at a time: columns n.. past N give zeros
__device__ __forceinline__ uint4 dyt8_ragged(const bf16* dy, const bf16* y, const float* ds1,
                                             const float* ds2, int n, int N) {
  uint4 d = make_uint4(0u, 0u, 0u, 0u);
  bf16* dh = reinterpret_cast<bf16*>(&d);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (n + q < N)
      dh[q] = __float2bfloat16_rn(dy_total(__bfloat162float(dy[q]), __bfloat162float(y[q]),
                                           ds1[n + q], ds2[n + q]));
  return d;
}

// 8 bf16 of row src from column c, zeros from column `end` on
__device__ __forceinline__ uint4 load8_ragged(const bf16* src, int c, int end) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (c + q < end) h[q] = src[q];
  return v;
}

// dx tile [128 rows of M] x [128 columns of K], contracting N 32 at a time:
// 8 warps as 2 x 4, 64 x 32 outputs each.
template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
bwd_dx_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const bf16* __restrict__ y, const bf16* __restrict__ dy,
                   const float* __restrict__ ds1, const float* __restrict__ ds2,
                   bf16* __restrict__ dx, float* __restrict__ part_da,
                   float* __restrict__ part_db, int M, int N, int K,
                   int has_prologue, int relu_in) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[TILE][S_LD];   // dyt: As[m][n]
  __shared__ __align__(128) bf16 Bs[TILE][S_LD];   // W:   Bs[k][n], W^T read col-major
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ float colred[2][2][TILE];             // [da|db][warp row][column]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int n0 = 0; n0 < N; n0 += H_BK) {
    // 128 rows x 32 n of dyt, and of W: 512 chunks of 8 each, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 2, nc = (idx & 3) * 8;
      const int gm = m0 + row, gk = k0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M) {
        const size_t off = (size_t)gm * N + n0 + nc;
        v = RAGGED ? dyt8_ragged(dy + off, y + off, ds1, ds2, n0 + nc, N)
                   : dyt8(dy + off, y + off, ds1, ds2, n0 + nc);
      }
      *reinterpret_cast<uint4*>(&As[row][nc]) = v;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K) {
        const bf16* src = w + (size_t)gk * N + n0 + nc;
        u = RAGGED ? load8_ragged(src, n0 + nc, N) : *reinterpret_cast<const uint4*>(src);
      }
      *reinterpret_cast<uint4*>(&Bs[row][nc]) = u;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[wm * 64 + i * 16][kk], S_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[wn * 32 + j * 16][kk], S_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through the warp's staging tile: lane owns column (lane & 15)
  // and rows (lane >> 4) * 8 + {0..7} of each 16x16 accumulator
  float* st = stage[warp];
  const int c = lane & 15, rh = lane >> 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = wn * 32 + j * 16 + c;
    const int gk = k0 + col;
    const bool k_live = gk < K;
    const float ak = (has_prologue && k_live) ? a[gk] : 0.f;
    const float bk = (has_prologue && k_live) ? b[gk] : 0.f;
    float sda = 0.f, sdb = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = rh * 8 + r;
        const int gm = m0 + wm * 64 + i * 16 + row;
        float v = st[row * 16 + c];
        if (gm < M && k_live) {
          const size_t off = (size_t)gm * K + gk;
          if (has_prologue) {
            const float xv = __bfloat162float(x[off]);
            if (relu_in && !(pre_act(xv, ak, bk) > 0.f)) v = 0.f;
            sda += v * xv;
            sdb += v;
            v = __fmul_rn(v, ak);
          }
          dx[off] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
    sda += __shfl_xor_sync(0xffffffffu, sda, 16);
    sdb += __shfl_xor_sync(0xffffffffu, sdb, 16);
    if (rh == 0) {
      colred[0][wm][col] = sda;
      colred[1][wm][col] = sdb;
    }
  }
  if (!has_prologue) return;   // uniform over the block
  __syncthreads();
  const int cc = tid & (TILE - 1), which = tid >> 7;
  if (k0 + cc < K)
    (which ? part_db : part_da)[(size_t)blockIdx.y * K + k0 + cc] =
        colred[which][0][cc] + colred[which][1][cc];
}

// dW partial tile [128 rows of K] x [128 columns of N] over the rows
// [split * chunk, (split + 1) * chunk) of M, 32 at a time.  The RAGGED
// template stores each 16x16 product through a per-warp staging tile, so
// that nothing past K or N is written.
template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
bwd_dw_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const bf16* __restrict__ y,
                   const bf16* __restrict__ dy, const float* __restrict__ ds1,
                   const float* __restrict__ ds2, float* __restrict__ part_dw,
                   int M, int N, int K, int chunk, int has_prologue, int relu_in) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[H_BK][W_LD];   // xhat: As[m][k], read col-major
  __shared__ __align__(128) bf16 Bs[H_BK][W_LD];   // dyt:  Bs[m][n]
  __shared__ __align__(128) float stage[RAGGED ? THREADS / 32 : 1][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * TILE, k0 = blockIdx.y * TILE;
  const int mbeg = blockIdx.z * chunk;
  const int mend = min(M, mbeg + chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int mm = mbeg; mm < mend; mm += H_BK) {
    // 32 rows x 128 columns of xhat and of dyt: 512 chunks of 8 each
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 4, cc = (idx & 15) * 8;
      const int gm = mm + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (RAGGED && gm < mend) {
        bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = k0 + cc + q;
          if (k >= K) continue;
          const bf16 xv = x[(size_t)gm * K + k];
          h[q] = has_prologue
                     ? __float2bfloat16_rn(xhat_of(__bfloat162float(xv), a[k], b[k], relu_in))
                     : xv;
        }
      } else if (gm < mend && k0 + cc < K) {
        v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + cc);
        if (has_prologue) {
          bf162* h = reinterpret_cast<bf162*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = k0 + cc + 2 * q;
            const float2 f = __bfloat1622float2(h[q]);
            h[q] = __floats2bfloat162_rn(xhat_of(f.x, a[k], b[k], relu_in),
                                         xhat_of(f.y, a[k + 1], b[k + 1], relu_in));
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[row][cc]) = v;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gm < mend && n0 + cc < N) {
        const size_t off = (size_t)gm * N + n0 + cc;
        u = RAGGED ? dyt8_ragged(dy + off, y + off, ds1, ds2, n0 + cc, N)
                   : dyt8(dy + off, y + off, ds1, ds2, n0 + cc);
      }
      *reinterpret_cast<uint4*>(&Bs[row][cc]) = u;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[kk][wm * 64 + i * 16], W_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], W_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part_dw + (size_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + wm * 64 + i * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + wn * 32 + j * 16;
      if (gk >= K || gn >= N) continue;    // uniform over the warp
      if constexpr (RAGGED) {
        float* st = stage[warp];
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 16; e += 32) {
          const int r = e >> 4, c = e & 15;
          if (gk + r < K && gn + c < N) out[(size_t)(gk + r) * N + gn + c] = st[e];
        }
        __syncwarp();
      } else {
        wmma::store_matrix_sync(out + (size_t)gk * N + gn, acc[i][j], N, wmma::mem_row_major);
      }
    }
  }
}

// ------------------------------------------------------------ reduction
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// out[l] = sum over r of part[r][l]: one column per threadIdx.x, the 32
// threadIdx.y lanes take every 32nd row, then thread y == 0 adds the 32
// lane sums in order.  Fixed, so the result is the same on every run.
template <typename OutT>
__global__ void colsum_kernel(const float* __restrict__ part, OutT* __restrict__ out,
                              int R, long long L) {
  __shared__ float red[32][33];
  const long long l = (long long)blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (l < L)
    for (int r = threadIdx.y; r < R; r += 32) t += part[(size_t)r * L + l];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && l < L) {
    float u = 0.f;
    for (int r = 0; r < 32; ++r) u += red[r][threadIdx.x];
    put(out + l, u);
  }
}

template <typename T>
void colsum(const float* part, T* out, int R, long long L, cudaStream_t s) {
  colsum_kernel<T><<<(unsigned)((L + 31) / 32), dim3(32, 32), 0, s>>>(part, out, R, L);
}

template <typename T, typename DxKernel, typename DwKernel>
int launch(DxKernel dx_kernel, DwKernel dw_kernel, DxKernel dx_ragged, DwKernel dw_ragged,
           const void* x, const void* w, const void* a, const void* b, const void* y,
           const void* dy, const void* ds1,
           const void* ds2, void* dx, void* dw, void* da, void* db, void* part_da,
           void* part_db, void* part_dw, int M, int N, int K, int splits, int chunk,
           int has_prologue, int relu_in, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles_m = (M + TILE - 1) / TILE;
  const int tiles_k = (K + TILE - 1) / TILE;
  const int tiles_n = (N + TILE - 1) / TILE;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* s1 = static_cast<const float*>(ds1);
  const float* s2 = static_cast<const float*>(ds2);
  if (K % 32 || N % 32) {
    dx_kernel = dx_ragged;
    dw_kernel = dw_ragged;
  }
  dx_kernel<<<dim3(tiles_k, tiles_m), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), af, bf, static_cast<const T*>(y),
      static_cast<const T*>(dy), s1, s2, static_cast<T*>(dx), static_cast<float*>(part_da),
      static_cast<float*>(part_db), M, N, K, has_prologue, relu_in);
  dw_kernel<<<dim3(tiles_n, tiles_k, splits), THREADS, 0, s>>>(
      static_cast<const T*>(x), af, bf, static_cast<const T*>(y), static_cast<const T*>(dy),
      s1, s2, static_cast<float*>(part_dw), M, N, K, chunk, has_prologue, relu_in);
  if (has_prologue) {
    colsum(static_cast<const float*>(part_da), static_cast<float*>(da), tiles_m, K, s);
    colsum(static_cast<const float*>(part_db), static_cast<float*>(db), tiles_m, K, s);
  }
  colsum(static_cast<const float*>(part_dw), static_cast<T*>(dw), splits, (long long)K * N, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int matmul_bn_act_bwd_tile(void) { return TILE; }

int matmul_bn_act_bwd_f32(const void* x, const void* w, const void* a, const void* b,
                          const void* y, const void* dy, const void* ds1, const void* ds2,
                          void* dx, void* dw, void* da, void* db, void* part_da,
                          void* part_db, void* part_dw, int M, int N, int K, int splits,
                          int chunk, int has_prologue, int relu_in, void* stream) {
  return launch<float>(bwd_dx_f32_kernel<false>, bwd_dw_f32_kernel<false>,
                       bwd_dx_f32_kernel<true>, bwd_dw_f32_kernel<true>, x, w, a, b, y, dy,
                       ds1, ds2, dx, dw, da, db, part_da, part_db, part_dw, M, N, K, splits,
                       chunk, has_prologue, relu_in, stream);
}

int matmul_bn_act_bwd_bf16(const void* x, const void* w, const void* a, const void* b,
                           const void* y, const void* dy, const void* ds1, const void* ds2,
                           void* dx, void* dw, void* da, void* db, void* part_da,
                           void* part_db, void* part_dw, int M, int N, int K, int splits,
                           int chunk, int has_prologue, int relu_in, void* stream) {
  return launch<bf16>(bwd_dx_bf16_kernel<false>, bwd_dw_bf16_kernel<false>,
                      bwd_dx_bf16_kernel<true>, bwd_dw_bf16_kernel<true>, x, w, a, b, y, dy,
                      ds1, ds2, dx, dw, da, db, part_da, part_db, part_dw, M, N, K, splits,
                      chunk, has_prologue, relu_in, stream);
}

}  // extern "C"
