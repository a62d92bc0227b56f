// Fused 3x3 conv + BatchNorm statistics forward for Hopper (sm_90a).  For x
// [N, H, W, C] (NHWC), w [3, 3, C, Cout] (HWIO) and the optional per-channel
// fold a, b [C] (f32):
//
//     y[N,H,W,Cout] = conv3x3, stride 1, SAME, of act(x * a + b)
//                     (act = relu when relu_in; without a prologue x goes in
//                     as it is, unclipped)
//     s1[Cout] = sum over the N*H*W pixels of y       (f32)
//     s2[Cout] = sum over the N*H*W pixels of y*y     (f32)
//
// SAME padding pads the folded input with zeros: a tap outside the image adds
// nothing, not act(0 * a + b).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/conv3_bn.py
// (_fwd_impl -> _fwd_kernel, the whole image plane in VMEM, and
// _fwd_kernel_tiled, 8-row tiles with halo rows, for planes over 1 MB).  Both
// bodies compute one function; one design serves both here.
//
// What bounds it on the H100: 2 * N*H*W * 9C * Cout operations against
// (N*H*W * (C + Cout) + 9 C Cout) elements moved, so at ResNet-50's 3x3
// stages (C = Cout from 64 to 512) it is bound by operations: in f32 by the
// CUDA cores (67 TFLOP/s; the JAX kernel asks for Precision.HIGHEST, so no
// TF32), in bf16 by the tensor cores.
//
// What the design does about it: an implicit GEMM, with M = N*H*W output
// pixels, K = 9C (tap-major: k = (3 di + dj) C + c, which is HWIO read as a
// [9C, Cout] matrix) and N = Cout, on the tiles of csrc/matmul_bn_act.cu.
//   * The A tile is gathered: for output pixel m = (n, h, w) and tap
//     (di, dj) it reads the input pixel (h + di - 1, w + dj - 1) of the same
//     image, at flattened index m + (di - 1) W + (dj - 1), and gives zero
//     where that pixel lies outside the image (so neighbours never cross a
//     row's or an image's edge).  The BN fold is applied while the tile is
//     loaded, to the pixels inside the image only, so the normalised input
//     never goes to device memory.
//   * f32: 256 threads, 8x8 outputs per thread from registers, FMA in f32.
//     bf16: 8 warps of WMMA 16x16x16 (bf16 in, f32 accumulate); the folded
//     input is rounded to bf16 before the products, y once at the end.
//   * y is written from registers, and the same f32 values feed per-column
//     partial sums of the block (the statistics are sums of the f32
//     accumulator, not of the rounded y).  Each block writes its partials to
//     its own row of a [tiles_m, Cout] scratch; a second small kernel sums the
//     rows in a fixed order (no atomics, the same result on every run).
//   * Any N, H, W, C and Cout.  When C and Cout are multiples of 4 (f32) or
//     8 (bf16), as at every ResNet-50 shape, one 16-byte load brings a run of
//     channels of one tap; otherwise the RAGGED template loads and stores
//     element by element.  Past K = 9C both operands give zeros.
// A simple kernel: no cp.async/TMA pipelining, no wgmma, and no row tile
// with halo in shared memory (each input pixel is read by up to 9 tiles'
// gathers, from L2).
//
// Requirements checked by the Python wrapper: contiguous tensors, 16-byte
// aligned base pointers, N*H*W < 65536 * 128.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 128;
constexpr int TILE_N = 128;
constexpr int THREADS = 256;

struct ConvArgs {
  const void* x;        // [M, C], M = N*H*W
  const void* w;        // [9C, Cout]
  const float* a;       // [C]
  const float* b;       // [C]
  void* y;              // [M, Cout]
  float* part1;         // [tiles_m, Cout]
  float* part2;         // [tiles_m, Cout]
  int M, H, W, C, Cout, K, has_prologue, relu_in;
};

__device__ __forceinline__ float fold(float v, float a, float b, int relu_in) {
  // no FMA contraction: x*a rounds, then +b rounds, as in the plain version
  float h = __fadd_rn(__fmul_rn(v, a), b);
  return (relu_in && !(h > 0.f)) ? 0.f : h;
}

// Output pixel m's row and column in its image.
struct Pixel {
  int h, w;
  bool live;   // m < M
};

__device__ __forceinline__ Pixel pixel_of(const ConvArgs& p, int m) {
  Pixel px{0, 0, m < p.M};
  if (px.live) {
    const int hw = m % (p.H * p.W);
    px.h = hw / p.W;
    px.w = hw - px.h * p.W;
  }
  return px;
}

// Whether tap t (one of the 9, else none) of output pixel px reads an input
// pixel inside px's image; if so, that pixel's flattened offset from px in off.
__device__ __forceinline__ bool tap_inside(const ConvArgs& p, const Pixel& px, int t, int& off) {
  const int di = t / 3 - 1, dj = t % 3 - 1;
  off = di * p.W + dj;
  return px.live && t < 9 && (unsigned)(px.h + di) < (unsigned)p.H &&
         (unsigned)(px.w + dj) < (unsigned)p.W;
}

// ------------------------------------------------------------------ f32
constexpr int F_BK = 8;

template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
c3_f32_kernel(ConvArgs p) {
  __shared__ __align__(16) float As[F_BK][TILE_M];   // gathered input tile, k-major
  __shared__ __align__(16) float Bs[F_BK][TILE_N];   // W tile
  __shared__ float red1[16][TILE_N];
  __shared__ float red2[16][TILE_N];

  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  float* y = static_cast<float*>(p.y);
  const int M = p.M, N = p.Cout, K = p.K, C = p.C;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;

  // loaders: each thread brings 4 consecutive k of one output pixel and
  // 4 consecutive n of one W row per k-step
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_row = tid >> 5, b_n = (tid & 31) * 4;
  const int gm = m0 + a_row;
  const Pixel px = pixel_of(p, gm);
  const bool b_live = (n0 + b_n) < N;
  // the thread's k = k0 + a_k as (tap, channel), advanced by F_BK a step
  int tap = a_k / C, ch = a_k % C;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (!RAGGED) {
      // C % 4 == 0: the 4 k share one tap
      int off;
      if (tap_inside(p, px, tap, off)) {
        av = *reinterpret_cast<const float4*>(x + (size_t)(gm + off) * C + ch);
        if (p.has_prologue) {
          av.x = fold(av.x, p.a[ch + 0], p.b[ch + 0], p.relu_in);
          av.y = fold(av.y, p.a[ch + 1], p.b[ch + 1], p.relu_in);
          av.z = fold(av.z, p.a[ch + 2], p.b[ch + 2], p.relu_in);
          av.w = fold(av.w, p.a[ch + 3], p.b[ch + 3], p.relu_in);
        }
      }
      if (b_live && k0 + b_row < K)
        bv = *reinterpret_cast<const float4*>(w + (size_t)(k0 + b_row) * N + n0 + b_n);
      ch += F_BK;
      while (ch >= C) {
        ch -= C;
        ++tap;
      }
    } else {
      float* ae = &av.x;
      float* be = &bv.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + a_k + q, n = n0 + b_n + q;
        if (k < K) {
          const int t = k / C, c = k - t * C;
          int off;
          if (tap_inside(p, px, t, off)) {
            const float v = x[(size_t)(gm + off) * C + c];
            ae[q] = p.has_prologue ? fold(v, p.a[c], p.b[c], p.relu_in) : v;
          }
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
    const int om = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (om < M) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + h * 64 + tx * 4;
        if constexpr (!RAGGED) {
          if (gn < N)
            *reinterpret_cast<float4*>(y + (size_t)om * N + gn) = make_float4(
                acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (gn + q < N) y[(size_t)om * N + gn + q] = acc[i][h * 4 + q];
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
    (tid < TILE_N ? p.part1 : p.part2)[(size_t)blockIdx.y * N + n0 + c] = s;
  }
}

// ----------------------------------------------------------------- bf16
constexpr int H_BK = 32;
constexpr int A_LD = H_BK + 8;     // padded leading dims (multiples of 8)
constexpr int B_LD = TILE_N + 8;

template <bool RAGGED>
__global__ void __launch_bounds__(THREADS)
c3_bf16_kernel(ConvArgs p) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[TILE_M][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[H_BK][B_LD];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  __shared__ float colred[2][2][TILE_N];   // [s1|s2][warp row][column]

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const int M = p.M, N = p.Cout, K = p.K, C = p.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;

  // input tile: 128 pixels x 32 k = 512 chunks of 8 k, two per thread, at
  // pixels (tid >> 2) and 64 + (tid >> 2), the same 8 k
  const int kc = (tid & 3) * 8;
  const int gm[2] = {m0 + (tid >> 2), m0 + 64 + (tid >> 2)};
  const Pixel px[2] = {pixel_of(p, gm[0]), pixel_of(p, gm[1])};
  int tap = kc / C, ch = kc % C;   // k = k0 + kc as (tap, channel), advanced by H_BK

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += H_BK) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (RAGGED) {
        __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = k0 + kc + q;
          if (k >= K) continue;
          const int t = k / C, c = k - t * C;
          int off;
          if (!tap_inside(p, px[it], t, off)) continue;
          const __nv_bfloat16 xv = x[(size_t)(gm[it] + off) * C + c];
          hv[q] = p.has_prologue
                      ? __float2bfloat16_rn(fold(__bfloat162float(xv), p.a[c], p.b[c], p.relu_in))
                      : xv;
        }
      } else {
        // C % 8 == 0: the 8 k share one tap
        int off;
        if (tap_inside(p, px[it], tap, off)) {
          v = *reinterpret_cast<const uint4*>(x + (size_t)(gm[it] + off) * C + ch);
          if (p.has_prologue) {
            __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = ch + 2 * q;
              float2 f = __bfloat1622float2(hv[q]);
              f.x = fold(f.x, p.a[c], p.b[c], p.relu_in);
              f.y = fold(f.y, p.a[c + 1], p.b[c + 1], p.relu_in);
              hv[q] = __floats2bfloat162_rn(f.x, f.y);
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[(tid >> 2) + it * 64][kc]) = v;
    }
    if constexpr (!RAGGED) {
      ch += H_BK;
      while (ch >= C) {
        ch -= C;
        ++tap;
      }
    }
    // W tile: 32 k x 128 n = 512 chunks of 8 bf16, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int krow = idx >> 4, nc = (idx & 15) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (RAGGED) {
        __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (k0 + krow < K && n0 + nc + q < N) hv[q] = w[(size_t)(k0 + krow) * N + n0 + nc + q];
      } else if (k0 + krow < K && n0 + nc < N) {
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
        const int om = m0 + wm * 64 + i * 16 + row;
        const float v = st[row * 16 + c];
        if (om < M && gn < N) {
          y[(size_t)om * N + gn] = __float2bfloat16_rn(v);
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
    (which ? p.part2 : p.part1)[(size_t)blockIdx.y * N + n0 + cc] =
        colred[which][0][cc] + colred[which][1][cc];
}

// ------------------------------------------------------ stats reduction
// One column per threadIdx.x; the 32 threadIdx.y lanes take every 32nd tile
// row, then thread y == 0 adds the 32 partials in order: fixed, so the
// statistics are the same on every run (matmul_bn_act.cu's reduction).
__global__ void c3_stats_reduce_kernel(const float* __restrict__ part1,
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

int launch(void (*kernel)(ConvArgs), const void* x, const void* w, const void* a,
           const void* b, void* y, void* part1, void* part2, void* s1, void* s2, int n_img,
           int H, int W, int C, int Cout, int has_prologue, int relu_in, void* stream) {
  ConvArgs p;
  p.x = x;
  p.w = w;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.y = y;
  p.part1 = static_cast<float*>(part1);
  p.part2 = static_cast<float*>(part2);
  p.M = n_img * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cout = Cout;
  p.K = 9 * C;
  p.has_prologue = has_prologue;
  p.relu_in = relu_in;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles_m = (p.M + TILE_M - 1) / TILE_M;
  kernel<<<dim3((Cout + TILE_N - 1) / TILE_N, tiles_m), THREADS, 0, s>>>(p);
  c3_stats_reduce_kernel<<<(Cout + 31) / 32, dim3(32, 32), 0, s>>>(
      p.part1, p.part2, static_cast<float*>(s1), static_cast<float*>(s2), tiles_m, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv3x3_bn_act_tile_m(void) { return TILE_M; }

int conv3x3_bn_act_f32(const void* x, const void* w, const void* a, const void* b, void* y,
                       void* part1, void* part2, void* s1, void* s2, int n_img, int H, int W,
                       int C, int Cout, int has_prologue, int relu_in, void* stream) {
  const bool ragged = C % 4 || Cout % 4;
  return launch(ragged ? &c3_f32_kernel<true> : &c3_f32_kernel<false>, x, w, a, b, y, part1,
                part2, s1, s2, n_img, H, W, C, Cout, has_prologue, relu_in, stream);
}

int conv3x3_bn_act_bf16(const void* x, const void* w, const void* a, const void* b, void* y,
                        void* part1, void* part2, void* s1, void* s2, int n_img, int H, int W,
                        int C, int Cout, int has_prologue, int relu_in, void* stream) {
  const bool ragged = C % 8 || Cout % 8;
  return launch(ragged ? &c3_bf16_kernel<true> : &c3_bf16_kernel<false>, x, w, a, b, y, part1,
                part2, s1, s2, n_img, H, W, C, Cout, has_prologue, relu_in, stream);
}

}  // extern "C"
