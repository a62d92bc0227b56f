// int8-weight dequant-matmul for Hopper (sm_90a):
//
//     y[M,N] = (sum_k x[m,k] * w_q[k,n]) * scale[n]
//
// x f32 or bf16 [M, K], w_q int8 [K, N], scale f32 [N]; the sum is taken in
// f32 and y is written in x's dtype.  Replaces the TPU kernel
// deeplearning4j_tpu/ops/pallas/quant_matmul.py (int8_matmul_pallas ->
// _kernel), the dense layers of a post-training-quantized net.
//
// What bounds it on the H100: at serving batch sizes (M = 1..32) the int8
// weight is the traffic.  VGG-16's fc6 is 25088 x 4096 = 102.8 MB, 30.7 us
// at 3.35 TB/s; its 2*M*K*N operations are 0.2 us at M = 1 and 6.6 us at
// M = 32 on the tensor cores (989 TFLOP/s bf16), 3.1 and 98 us on the CUDA
// cores (67 TFLOP/s f32).  So bf16 is bound by bytes at every serving M, and
// f32 by bytes at small M and by operations at a full bucket.
//
// What the design does about it:
//   * The TPU kernel keeps the whole int8 weight resident in VMEM; here the
//     weight streams once from device memory, one byte per weight, read
//     along N in 4- or 8-byte words (byte loads when N is not a multiple of
//     4 or 8), and is widened in registers: no dequantized copy exists.
//   * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) on y^T = w^T x^T, so
//     the weight is the A operand and M (padded to 8, 16 or 32) the narrow
//     side.  The 16 k of an mma are taken 4 per thread (slots 2t, 2t+1,
//     2t+8, 2t+9 hold k rows 4t..4t+3, in both operands), and its 16 rows are
//     the columns 8g + 2j and 8g + 2j + 1 of the warp's 64, so one thread's
//     four 8-byte loads (k rows 4t..4t+3, columns 8g..8g+7) hold its A
//     operands for all four mma of a k step, and its x operand is one 8-byte
//     load (k 4t..4t+3 of one row).  int8 -> bf16 is exact for |v| <= 127, and
//     each product bf16 * int8 is exact in f32, as in the JAX kernel's bf16
//     dot with f32 accumulation.  A block of 4 warps owns 64 columns and
//     interleaves its K range in 16-k steps; each warp loads two steps ahead
//     of its products and the 4 warps' sums are added in warp order.
//   * f32: full f32 FMA on the CUDA cores (the JAX kernel asks for
//     Precision.HIGHEST, so no TF32).  A block owns 128 columns and MT rows
//     (MT = 1..32, the smallest power of two that holds min(M, 32) rows);
//     its 8 warps split each 64-k chunk (warp ty takes k rows 8ty..8ty+7),
//     accumulate MT x 4 outputs per thread while the next chunk's weight
//     words are in flight and the x chunk sits in shared memory, sum each
//     chunk's 8 products before they join the running sum (the rounding
//     error grows with K/64, not K/8), and are added in warp order.
//   * At small M a grid over (N, M) tiles alone gives fc6 32-64 blocks for
//     132 SMs, so K is split over blockIdx.z as well (about 4 blocks per SM):
//     each split writes f32 partials to its own slice of a [splits, M, N]
//     scratch, and a second kernel sums the slices in split order, applies
//     scale and casts.  The split count depends on K, N and the SM count
//     only, never on M; there are no float atomics, so results are the same
//     run to run.
//
// Requirements checked by the Python wrapper: contiguous row-major x and w_q;
// wvec set only when N and w_q's address allow the word loads (4 bytes f32,
// 8 bf16), xvec only when K % 4 == 0 and x is 8-byte aligned; k_per_split a
// multiple of KC; ceil(M / 32) < 65536.  Every entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KC = 64;   // a split's K range is a multiple of this

// ------------------------------------------------------------------ f32
constexpr int F_THREADS = 256;
constexpr int F_TILE_N = 128;   // 32 threads x 4 columns
constexpr int F_LANES = 8;      // warps splitting each k chunk
constexpr int F_KW = KC / F_LANES;

// four int8 weights of row k at columns n..n+3, zero past kend or N
template <bool VEC>
__device__ __forceinline__ char4 load_w4(const int8_t* __restrict__ w, int k, int n,
                                         int kend, int N) {
  char4 c = make_char4(0, 0, 0, 0);
  if (k >= kend) return c;
  const int8_t* p = w + (size_t)k * N + n;
  if (VEC) {
    if (n < N) c = *reinterpret_cast<const char4*>(p);
  } else {
    if (n < N) c.x = p[0];
    if (n + 1 < N) c.y = p[1];
    if (n + 2 < N) c.z = p[2];
    if (n + 3 < N) c.w = p[3];
  }
  return c;
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   float* __restrict__ part, int M, int N, int K, int k_per_split) {
  __shared__ __align__(16) float xs[MT][KC];
  __shared__ __align__(16) float red[MT][F_TILE_N];

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * F_TILE_N, m0 = blockIdx.y * MT;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int n = n0 + 4 * tx;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  // this warp's weight words of the first chunk; each later chunk's are
  // loaded while the current one computes, so weight loads stay in flight
  char4 wq[F_KW];
#pragma unroll
  for (int j = 0; j < F_KW; ++j) wq[j] = load_w4<VEC>(w, kbeg + F_KW * ty + j, n, kend, N);

  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    constexpr int PER_THREAD = (MT * KC + F_THREADS - 1) / F_THREADS;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int i = tid + r * F_THREADS;
      if (MT * KC % F_THREADS == 0 || i < MT * KC) {
        const int m = i / KC, kk = i % KC;
        const int gm = m0 + m, gk = k0 + kk;
        xs[m][kk] = (gm < M && gk < kend) ? x[(size_t)gm * K + gk] : 0.f;
      }
    }
    __syncthreads();
    float wf[F_KW][4];
#pragma unroll
    for (int j = 0; j < F_KW; ++j) {
      wf[j][0] = (float)wq[j].x;
      wf[j][1] = (float)wq[j].y;
      wf[j][2] = (float)wq[j].z;
      wf[j][3] = (float)wq[j].w;
    }
#pragma unroll
    for (int j = 0; j < F_KW; ++j) wq[j] = load_w4<VEC>(w, k0 + KC + F_KW * ty + j, n, kend, N);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // every thread of the warp reads the same words: a broadcast
      const float4 xa = *reinterpret_cast<const float4*>(&xs[m][F_KW * ty]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[m][F_KW * ty + 4]);
      const float xv[F_KW] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      // the chunk's 8 products summed first, then added to the running sum
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = xv[0] * wf[0][c];
#pragma unroll
        for (int j = 1; j < F_KW; ++j) t = fmaf(xv[j], wf[j][c], t);
        acc[m][c] += t;
      }
    }
    __syncthreads();
  }

  // the 8 warps' sums, added in warp order
  for (int lane = 0; lane < F_LANES; ++lane) {
    if (ty == lane) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float4* r = reinterpret_cast<float4*>(&red[m][4 * tx]);
        float4 v = lane == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *r;
        v.x += acc[m][0];
        v.y += acc[m][1];
        v.z += acc[m][2];
        v.w += acc[m][3];
        *r = v;
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * M * N;
  for (int i = tid; i < MT * F_TILE_N; i += F_THREADS) {
    const int m = i / F_TILE_N, c = i % F_TILE_N;
    if (m0 + m < M && n0 + c < N) out[(size_t)(m0 + m) * N + n0 + c] = red[m][c];
  }
}

// ------------------------------------------------------------------ bf16
constexpr int B_WARPS = 4;
constexpr int B_THREADS = 32 * B_WARPS;
constexpr int B_TILE_N = 64;   // per block (and per warp): 8 columns per thread group g
constexpr int B_AHEAD = 2;     // 16-k steps whose loads a warp issues before their products

// d (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte b (0..7) of an 8-byte word, as a signed int
__device__ __forceinline__ int byte_of(uint2 v, int b) {
  const uint32_t word = b < 4 ? v.x : v.y;
  return (int)(int8_t)(word >> (8 * (b & 3)));
}

// two int8 widened to bf16 (exact for |v| <= 127), the first in the low half
__device__ __forceinline__ uint32_t pack_i8(int lo, int hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight int8 weights of row k at columns n..n+7, zero past kend or N
template <bool VEC>
__device__ __forceinline__ uint2 load_w8(const int8_t* __restrict__ w, int k, int n, int kend,
                                         int N) {
  uint2 v = make_uint2(0u, 0u);
  if (k >= kend) return v;
  const int8_t* p = w + (size_t)k * N + n;
  if (VEC) {
    if (n < N) v = *reinterpret_cast<const uint2*>(p);
  } else {
    uint32_t b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = n + i < N ? (uint32_t)(uint8_t)p[i] : 0u;
    v.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    v.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
  }
  return v;
}

// x[m][k..k+3] as two bf16 pairs, zero past M or kend
__device__ __forceinline__ uint2 load_x4(const bf16* __restrict__ x, int m, int k, int kend,
                                         int M, int K, int xvec) {
  uint2 v = make_uint2(0u, 0u);
  if (m >= M || k >= kend) return v;
  const bf16* p = x + (size_t)m * K + k;
  if (xvec && k + 3 < kend) return *reinterpret_cast<const uint2*>(p);
  uint16_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = k + i < kend ? *reinterpret_cast<const uint16_t*>(p + i) : (uint16_t)0;
  v.x = (uint32_t)h[0] | ((uint32_t)h[1] << 16);
  v.y = (uint32_t)h[2] | ((uint32_t)h[3] << 16);
  return v;
}

template <int MB, bool VEC>
__global__ void __launch_bounds__(B_THREADS)
int8_mm_bf16_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ part, int M, int N, int K, int k_per_split, int xvec) {
  constexpr int MT = 8 * MB;
  __shared__ float red[B_TILE_N][MT + 1];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nb = blockIdx.x * B_TILE_N, m0 = blockIdx.y * MT;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  // acc[j][mb]: mma j's rows are columns nb + 8g + 2j (+1 for rows g + 8),
  // its columns rows m0 + 8mb + 2t (+1)
  float acc[4][MB][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][mb][c] = 0.f;

  // warp w takes the 16-k steps kbeg + 16 (w + 4 i)
  for (int k0 = kbeg + 16 * warp; k0 < kend; k0 += 16 * B_WARPS * B_AHEAD) {
    uint2 wv[B_AHEAD][4], xv[B_AHEAD][MB];
#pragma unroll
    for (int u = 0; u < B_AHEAD; ++u) {
      const int ks = k0 + 16 * B_WARPS * u + 4 * t;   // this thread's k rows ks..ks+3
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[u][i] = load_w8<VEC>(w, ks + i, nb + 8 * g, kend, N);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) xv[u][mb] = load_x4(x, m0 + 8 * mb + g, ks, kend, M, K, xvec);
    }
#pragma unroll
    for (int u = 0; u < B_AHEAD; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {
            pack_i8(byte_of(wv[u][0], 2 * j), byte_of(wv[u][1], 2 * j)),
            pack_i8(byte_of(wv[u][0], 2 * j + 1), byte_of(wv[u][1], 2 * j + 1)),
            pack_i8(byte_of(wv[u][2], 2 * j), byte_of(wv[u][3], 2 * j)),
            pack_i8(byte_of(wv[u][2], 2 * j + 1), byte_of(wv[u][3], 2 * j + 1))};
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) mma_bf16(acc[j][mb], a, xv[u][mb].x, xv[u][mb].y);
      }
    }
  }

  // the 4 warps' sums, added in warp order
  for (int v = 0; v < B_WARPS; ++v) {
    if (warp == v) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& r = red[8 * g + 2 * j + (c >> 1)][8 * mb + 2 * t + (c & 1)];
            r = (v == 0 ? 0.f : r) + acc[j][mb][c];
          }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * M * N;
  for (int i = tid; i < MT * B_TILE_N; i += B_THREADS) {
    const int m = i / B_TILE_N, c = i % B_TILE_N;
    if (m0 + m < M && nb + c < N) out[(size_t)(m0 + m) * N + nb + c] = red[c][m];
  }
}

// ------------------------------------------------------------ reduce
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256)
int8_mm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                      T* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * total + i];
  store(&y[i], s * scale[i % N]);
}

template <typename T>
int reduce(const float* part, const void* scale, void* y, int M, int N, int splits,
           cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  int8_mm_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, (const float*)scale, (T*)y, M, N,
                                                       splits);
  return (int)cudaGetLastError();
}

template <int MT>
void launch_f32(const float* x, const int8_t* w, float* part, int M, int N, int K, int kps,
                int splits, int wvec, cudaStream_t stream) {
  const dim3 grid((N + F_TILE_N - 1) / F_TILE_N, (M + MT - 1) / MT, splits);
  if (wvec)
    int8_mm_f32_kernel<MT, true><<<grid, F_THREADS, 0, stream>>>(x, w, part, M, N, K, kps);
  else
    int8_mm_f32_kernel<MT, false><<<grid, F_THREADS, 0, stream>>>(x, w, part, M, N, K, kps);
}

template <int MB>
void launch_bf16(const bf16* x, const int8_t* w, float* part, int M, int N, int K, int kps,
                 int splits, int wvec, int xvec, cudaStream_t stream) {
  const dim3 grid((N + B_TILE_N - 1) / B_TILE_N, (M + 8 * MB - 1) / (8 * MB), splits);
  if (wvec)
    int8_mm_bf16_kernel<MB, true><<<grid, B_THREADS, 0, stream>>>(x, w, part, M, N, K, kps,
                                                                  xvec);
  else
    int8_mm_bf16_kernel<MB, false><<<grid, B_THREADS, 0, stream>>>(x, w, part, M, N, K, kps,
                                                                   xvec);
}

}  // namespace

extern "C" {

int int8_matmul_kc(void) { return KC; }
int int8_matmul_tile_n(int bf16_path) { return bf16_path ? B_TILE_N : F_TILE_N; }

int int8_matmul_f32(const void* x, const void* w, const void* scale, void* y, void* part,
                    int M, int N, int K, int k_per_split, int splits, int wvec, int xvec,
                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* xp = (const float*)x;
  const int8_t* wp = (const int8_t*)w;
  float* pp = (float*)part;
  const int rows = M < 32 ? M : 32;
  if (rows <= 1) launch_f32<1>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  else if (rows <= 2) launch_f32<2>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  else if (rows <= 4) launch_f32<4>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  else if (rows <= 8) launch_f32<8>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  else if (rows <= 16) launch_f32<16>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  else launch_f32<32>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, stream);
  const int rc = (int)cudaGetLastError();
  return rc != 0 ? rc : reduce<float>(pp, scale, y, M, N, splits, stream);
}

int int8_matmul_bf16(const void* x, const void* w, const void* scale, void* y, void* part,
                     int M, int N, int K, int k_per_split, int splits, int wvec, int xvec,
                     void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bf16* xp = (const bf16*)x;
  const int8_t* wp = (const int8_t*)w;
  float* pp = (float*)part;
  const int rows = M < 32 ? M : 32;
  if (rows <= 8) launch_bf16<1>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, xvec, stream);
  else if (rows <= 16) launch_bf16<2>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, xvec, stream);
  else launch_bf16<4>(xp, wp, pp, M, N, K, k_per_split, splits, wvec, xvec, stream);
  const int rc = (int)cudaGetLastError();
  return rc != 0 ? rc : reduce<bf16>(pp, scale, y, M, N, splits, stream);
}

}  // extern "C"
