// Fused 1x1-conv + BatchNorm forward for Hopper (sm_90a):
//
//     y[M,N]  = act(x * a + b) @ W          (act = relu when relu_in; the
//                                            prologue is skipped without a)
//     s1[N]   = sum over the M real rows of y      (f32)
//     s2[N]   = sum over the M real rows of y*y    (f32)
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/conv_bn.py
// (_fwd_impl -> _fwd_kernel), which runs the 1x1 convs of every ResNet-50
// bottleneck.  A 1x1 conv over NHWC is [N*H*W, Cin] @ [Cin, Cout].
//
// What bounds it on the H100: in f32 the product is accumulated in full f32
// on the CUDA cores (the JAX kernel asks for Precision.HIGHEST, so no TF32),
// whose peak is 67 TFLOP/s; at ResNet-50's channel widths (K, N from 64 to
// 2048) most shapes are then bound by operations, the K=N=64 ones by bytes.
// In bf16 the tensor cores (989 TFLOP/s) leave most shapes bound by the
// bytes of x and y.
//
// What the design does about it: one pass over x and one write of y.
//   * Shared-memory tiles of x (128 rows) and W (128 columns).  The
//     previous BN's fold act(x*a+b) is applied while the x tile is loaded,
//     so the normalised activation never goes to device memory.
//   * f32: 256 threads, 8x8 outputs per thread from registers, FMA in f32.
//     bf16: 8 warps of WMMA 16x16x16 (bf16 in, f32 accumulate).
//   * y is written from registers (via a per-warp 16x16 staging tile for
//     WMMA), and the same f32 values feed the per-column partial sums of the
//     block, so the statistics cost no second read of y.  Rows past M are
//     masked out of both.  Each block writes its partials to its own row of
//     a [tiles_m, N] scratch; a second small kernel sums the rows in a fixed
//     order, so the result is deterministic (no atomics).
//   * Any K and N.  When both are multiples of 32 (every ResNet-50 shape)
//     the loaders move 16 bytes a thread.  Otherwise the RAGGED template
//     loads and stores element by element (rows of a ragged K or N need not
//     be 16-byte aligned) and guards the tails: x and W give zeros past K,
//     so the K tail adds exactly nothing (a folded zero would add
//     act(b) * W), W gives zeros past N, and nothing past N is written.
//
// Requirements checked by the Python wrapper: contiguous row-major tensors,
// 16-byte aligned base pointers, M < 65536 * 128.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 128;
constexpr int TILE_N = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ float fold(float v, float a, float b, int relu_in) {
  // no FMA contraction: x*a rounds, then +b rounds, as in the plain version
  float h = __fadd_rn(__fmul_rn(v, a), b);
  return (relu_in && !(h > 0.f)) ? 0.f : h;
}

// ------------------------------------------------------------------ f32
constexpr int F_BK = 8;

template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
mba_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ y, float* __restrict__ part1,
               float* __restrict__ part2, int M, int N, int K,
               int has_prologue, int relu_in) {
  __shared__ __align__(16) float As[F_BK][TILE_M];   // x tile, k-major
  __shared__ __align__(16) float Bs[F_BK][TILE_N];   // W tile
  __shared__ float red1[16][TILE_N];
  __shared__ float red2[16][TILE_N];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;

  // loaders: each thread brings 4 consecutive k of one x row and
  // 4 consecutive n of one W row per k-step
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_row = tid >> 5, b_n = (tid & 31) * 4;
  const bool a_live = (m0 + a_row) < M;
  const bool b_live = (n0 + b_n) < N;
  const float* xp = x + (size_t)(a_live ? m0 + a_row : 0) * K + a_k;
  const float* wp = w + (size_t)b_row * N + (b_live ? n0 + b_n : 0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (!RAGGED) {
      if (a_live) {
        av = *reinterpret_cast<const float4*>(xp + k0);
        if (has_prologue) {
          const int k = k0 + a_k;
          av.x = fold(av.x, a[k + 0], b[k + 0], relu_in);
          av.y = fold(av.y, a[k + 1], b[k + 1], relu_in);
          av.z = fold(av.z, a[k + 2], b[k + 2], relu_in);
          av.w = fold(av.w, a[k + 3], b[k + 3], relu_in);
        }
      }
      if (b_live) bv = *reinterpret_cast<const float4*>(wp + (size_t)k0 * N);
    } else {
      float* ae = &av.x;
      float* be = &bv.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + a_k + q, n = n0 + b_n + q;
        if (a_live && k < K) {
          const float v = x[(size_t)(m0 + a_row) * K + k];
          ae[q] = has_prologue ? fold(v, a[k], b[k], relu_in) : v;
        }
        if (n < N && k0 + b_row < K) be[q] = w[(size_t)(k0 + b_row) * N + n];
      }
    }
    As[a_k + 0][a_row] = av.x;
    As[a_k + 1][a_row] = av.y;
    As[a_k + 2][a_row] = av.z;
    As[a_k + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_row][b_n]) = bv;
    __syncthreads();

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
    __syncthreads();
  }

  // epilogue: rows ty*4+{0..3} and 64+ty*4+{0..3}; columns likewise with tx
  float cs1[8], cs2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cs1[j] = cs2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm < M) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + h * 64 + tx * 4;
        if constexpr (!RAGGED) {
          if (gn < N)
            *reinterpret_cast<float4*>(y + (size_t)gm * N + gn) = make_float4(
                acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (gn + q < N) y[(size_t)gm * N + gn + q] = acc[i][h * 4 + q];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs1[j] += acc[i][j];
        cs2[j] += acc[i][j] * acc[i][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
    red1[ty][c] = cs1[j];
    red2[ty][c] = cs2[j];
  }
  __syncthreads();
  const int c = tid & (TILE_N - 1);
  if (n0 + c < N) {
    float (*red)[TILE_N] = tid < TILE_N ? red1 : red2;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[t][c];
    (tid < TILE_N ? part1 : part2)[(size_t)blockIdx.y * N + n0 + c] = s;
  }
}

// ----------------------------------------------------------------- bf16
constexpr int H_BK = 32;
constexpr int A_LD = H_BK + 8;     // padded leading dims (multiples of 8)
constexpr int B_LD = TILE_N + 8;

template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
mba_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ a, const float* __restrict__ b,
                __nv_bfloat16* __restrict__ y, float* __restrict__ part1,
                float* __restrict__ part2, int M, int N, int K,
                int has_prologue, int relu_in) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[TILE_M][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[H_BK][B_LD];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ float colred[2][2][TILE_N];   // [s1|s2][warp row][column]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += H_BK) {
    // x tile: 128 rows x 32 k = 512 chunks of 8 bf16, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 2, kc = (idx & 3) * 8;
      const int gm = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (RAGGED && gm < M) {
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = k0 + kc + q;
          if (k >= K) continue;
          const __nv_bfloat16 xv = x[(size_t)gm * K + k];
          h[q] = has_prologue
                     ? __float2bfloat16_rn(fold(__bfloat162float(xv), a[k], b[k], relu_in))
                     : xv;
        }
      } else if (gm < M) {
        v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + kc);
        if (has_prologue) {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = k0 + kc + 2 * q;
            float2 f = __bfloat1622float2(h[q]);
            f.x = fold(f.x, a[k], b[k], relu_in);
            f.y = fold(f.y, a[k + 1], b[k + 1], relu_in);
            h[q] = __floats2bfloat162_rn(f.x, f.y);
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[row][kc]) = v;
    }
    // W tile: 32 k x 128 n = 512 chunks of 8 bf16, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int krow = idx >> 4, nc = (idx & 15) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (RAGGED) {
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (k0 + krow < K && n0 + nc + q < N) h[q] = w[(size_t)(k0 + krow) * N + n0 + nc + q];
      } else if (n0 + nc < N) {
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + krow) * N + n0 + nc);
      }
      *reinterpret_cast<uint4*>(&Bs[krow][nc]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[wm * 64 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16x16 accumulator goes through the warp's staging tile;
  // lane owns column (lane & 15) and rows (lane >> 4) * 8 + {0..7}
  float* st = stage[warp];
  const int c = lane & 15, rh = lane >> 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = wn * 32 + j * 16 + c;
    const int gn = n0 + col;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = rh * 8 + r;
        const int gm = m0 + wm * 64 + i * 16 + row;
        const float v = st[row * 16 + c];
        if (gm < M && gn < N) {
          y[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
          s1 += v;
          s2 += v * v;
        }
      }
      __syncwarp();
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    if (rh == 0) {
      colred[0][wm][col] = s1;
      colred[1][wm][col] = s2;
    }
  }
  __syncthreads();
  const int cc = tid & (TILE_N - 1), which = tid >> 7;
  if (n0 + cc < N)
    (which ? part2 : part1)[(size_t)blockIdx.y * N + n0 + cc] =
        colred[which][0][cc] + colred[which][1][cc];
}

// ------------------------------------------------------ stats reduction
// One column per threadIdx.x; the 32 threadIdx.y lanes take every 32nd tile
// row, then thread y == 0 adds the 32 partials in order: fixed, so the
// statistics are the same on every run.
__global__ void stats_reduce_kernel(const float* __restrict__ part1,
                                    const float* __restrict__ part2,
                                    float* __restrict__ s1, float* __restrict__ s2,
                                    int tiles_m, int N) {
  __shared__ float r1[32][33];
  __shared__ float r2[32][33];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float t1 = 0.f, t2 = 0.f;
  if (n < N) {
    for (int t = threadIdx.y; t < tiles_m; t += 32) {
      t1 += part1[(size_t)t * N + n];
      t2 += part2[(size_t)t * N + n];
    }
  }
  r1[threadIdx.y][threadIdx.x] = t1;
  r2[threadIdx.y][threadIdx.x] = t2;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float u1 = 0.f, u2 = 0.f;
    for (int t = 0; t < 32; ++t) {
      u1 += r1[t][threadIdx.x];
      u2 += r2[t][threadIdx.x];
    }
    s1[n] = u1;
    s2[n] = u2;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, Kernel ragged_kernel, const void* x, const void* w, const void* a,
           const void* b, void* y, void* part1, void* part2, void* s1, void* s2,
           int M, int N, int K, int has_prologue, int relu_in, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles_m = (M + TILE_M - 1) / TILE_M;
  dim3 grid((N + TILE_N - 1) / TILE_N, tiles_m);
  Kernel k = (K % 32 || N % 32) ? ragged_kernel : kernel;
  k<<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(part1), static_cast<float*>(part2), M, N, K, has_prologue, relu_in);
  stats_reduce_kernel<<<(N + 31) / 32, dim3(32, 32), 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      static_cast<float*>(s1), static_cast<float*>(s2), tiles_m, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int matmul_bn_act_tile_m(void) { return TILE_M; }

int matmul_bn_act_f32(const void* x, const void* w, const void* a, const void* b,
                      void* y, void* part1, void* part2, void* s1, void* s2,
                      int M, int N, int K, int has_prologue, int relu_in, void* stream) {
  return launch<float>(mba_f32_kernel<false>, mba_f32_kernel<true>, x, w, a, b, y, part1,
                       part2, s1, s2, M, N, K, has_prologue, relu_in, stream);
}

int matmul_bn_act_bf16(const void* x, const void* w, const void* a, const void* b,
                       void* y, void* part1, void* part2, void* s1, void* s2,
                       int M, int N, int K, int has_prologue, int relu_in, void* stream) {
  return launch<__nv_bfloat16>(mba_bf16_kernel<false>, mba_bf16_kernel<true>, x, w, a, b, y,
                               part1, part2, s1, s2, M, N, K, has_prologue, relu_in, stream);
}

}  // extern "C"
