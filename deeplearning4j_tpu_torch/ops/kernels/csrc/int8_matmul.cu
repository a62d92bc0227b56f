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
// at 3.35 TB/s; its 2*M*K*N operations at M = 32 are 6.6 us in bf16 (989
// TFLOP/s) and 39.9 us in f32 as three TF32 passes (495 TFLOP/s, below).
// So bf16 is bound by the weight's bytes at every serving M, and f32 up to
// M = 16 and by operations at a full bucket.
//
// What the design does about it: wgmma fed by TMA on the GEMM core of
// gemm_sm90.cuh, on the swapped product y^T = w_q^T x^T:
//   * The weight is wgmma's A, 64 of its columns to a consumer warpgroup
//     (128 to a block), from registers.  It streams once from device memory
//     by TMA through a ring of int8 stages (one byte a weight; no
//     dequantized copy exists).  Each lane takes its A fragment by one
//     ldmatrix.trans per 32 k rows, which hands it, for two of its warp's
//     columns side by side (accumulator rows g and g + 8 hold columns 2 g
//     and 2 g + 1 of the warp's 16), the bytes of k rows 2 t and 2 t + 1:
//     conflict-free in the 128-byte swizzle, and widened exactly in
//     registers (i8_f32: a byte permute and one add; bf16 takes the f32's
//     high half).
//   * x is the B operand: [M, K] row-major is K-major for both dtypes, and
//     M (padded to MT = 8, 16 or 32) is wgmma's N.  bf16 takes x's tiles as
//     the TMA brings them.  f32 runs x in TF32 parts against the weight,
//     which is exact in TF32 and needs no part of its own: three, x = x1 +
//     x2 + x3 (two, x_hi + x_lo with x_lo truncated to TF32 by the tensor
//     core, keep 1e-7 of max |y|, a few ulps, and VGG-16's f32 logits
//     against the exact product need less).  The prep threads split each x
//     tile, its k rows permuted within each 8 (k 2 i at slot i, 2 i + 1 at
//     slot i + 4) to meet the k rows the weight's ldmatrix.trans hands each
//     lane.
//   * Products land in fresh tiles added to the sum in f32, since the
//     tensor core's adds round toward zero: bf16 a tile a stage; f32 the
//     large terms (w x1) a tile per 16 k and the small ones (w x2, w x3) a
//     tile a stage, added with a compensated (Kahan) sum, its K splits added
//     in f64 and y rounded once after the scale: VGG-16's f32 logits against
//     the exact product need all of that.
//   * K splits over blockIdx.z where the column tiles cannot fill the card
//     (quant_matmul.k_splits, from K, N and the SM count only, never M: a
//     row's sum order does not depend on its batch).  Each split writes its
//     partial; the last split of a tile to arrive adds them in a fixed
//     order, applies scale and writes y, in the same launch.  No float
//     atomics: results repeat bit for bit.
//   * The TMA takes rows of a multiple of 16 bytes: where N is not one
//     (VGG-16's fc8, N = 1000), the wrapper hands the kernel a copy of w_q
//     with rows zero-padded to 16 bytes (ldw), made once per weight.
//
// Requirements checked and met by the Python wrapper (quant_matmul.py):
// contiguous row-major x (rows of ldx elements, a multiple of 16 bytes,
// zero past K; 16-byte aligned) and w_q (rows of ldw bytes, a multiple of
// 16, zero past N; 16-byte aligned); k_per_split a multiple of I8_KC;
// the scratch [splits, M, N] f32 and zeroed arrival counts [tiles] when
// splits > 1; ceil(M / 32) < 65536.  Every entry point returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for tensor maps
// the CUDA driver refuses).

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int I8_BN = 128;   // weight columns of a block: 64 per consumer warpgroup
constexpr int I8_KC = 128;   // a split's K range is a multiple of this
constexpr int I8_ST = 6;     // stages
constexpr int I8_GROUP = 8;  // K splits summed first in groups of this many

struct I8Args {
  const float* scale;   // [N]
  void* y;              // [M, N]
  void* part;           // [splits (+ groups), M, N] (splits > 1): f32, f64 for f32 x
  int* counts;          // zeros: per tile (splits > 1; gemm_sm90.cuh's splitk_sum)
  int M, N, K, per, splits;
};

struct alignas(64) I8Maps {
  CUtensorMap x;        // [M, ldx]: boxes [MT rows, 128 bytes]
  CUtensorMap w;        // int8 [K, ldw]: boxes [KS rows, 128 bytes]
  I8Args a;
};

// Shared memory: I8_ST stages of the weight tile [KS rows, 128 columns] and
// the x tile [MT rows, KS] (two boxes; f32: its three TF32 parts); barriers.
template <bool F32, int MT>
struct I8Smem {
  static constexpr int KS = F32 ? 64 : 128;     // k rows a stage takes
  static constexpr int WT = KS * 128, XT = 2 * MT * 128;
  static constexpr int STAGE = WT + (F32 ? 3 : 1) * XT;
  static constexpr int BARS = I8_ST * STAGE;
  static constexpr size_t BYTES = 1024 + BARS + 8 * 3 * I8_ST;
};

// prep, f32: an x tile (two boxes [MT rows, 32]) split into three TF32
// parts, x = x1 + x2 + x3 (x1 = x rounded to TF32 in place, x2 the rest
// rounded, x3 what is left, exact; at XT and 2 XT bytes on), each 8 k rows
// permuted (k 2 i to slot i, 2 i + 1 to slot i + 4)
template <int MT>
__device__ __forceinline__ void split_x(unsigned char* xt, int pt) {
  constexpr int XT = 2 * MT * 128;
  for (int i = pt; i < 2 * MT * 4; i += GEMM_PREP) {
    const int bx = i / (MT * 4), row = (i >> 2) % MT, q = i & 3;
    unsigned char* r = xt + bx * MT * 128 + row * 128;
    float4* c0 = reinterpret_cast<float4*>(r + (((2 * q) ^ (row & 7)) << 4));
    float4* c1 = reinterpret_cast<float4*>(r + (((2 * q + 1) ^ (row & 7)) << 4));
    const float4 u = *c0, v = *c1;
    const float x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    float h[8], m[8], l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = __uint_as_float(tf32_hi(x[e]));
      const float rest = x[e] - h[e];
      m[e] = __uint_as_float(tf32_hi(rest));
      l[e] = rest - m[e];
    }
    *c0 = make_float4(h[0], h[2], h[4], h[6]);
    *c1 = make_float4(h[1], h[3], h[5], h[7]);
    unsigned char* b0 = reinterpret_cast<unsigned char*>(c0);
    unsigned char* b1 = reinterpret_cast<unsigned char*>(c1);
    *reinterpret_cast<float4*>(b0 + XT) = make_float4(m[0], m[2], m[4], m[6]);
    *reinterpret_cast<float4*>(b1 + XT) = make_float4(m[1], m[3], m[5], m[7]);
    *reinterpret_cast<float4*>(b0 + 2 * XT) = make_float4(l[0], l[2], l[4], l[6]);
    *reinterpret_cast<float4*>(b1 + 2 * XT) = make_float4(l[1], l[3], l[5], l[7]);
  }
}

// One block: weight columns [n0, n0 + 128) (blockIdx.x), x rows [m0, m0 +
// MT) (blockIdx.y), k rows [z per, z per + per) (blockIdx.z).  Consumer
// warpgroup wg owns columns n0 + 64 wg .. + 63: accumulator entry 4 j + 2 h
// + e of lane 4 g + t of its warp wq is column n0 + 64 wg + 16 wq + 2 g + h,
// row m0 + 8 j + 2 t + e of x and y.
template <bool F32, int MT>
__device__ __forceinline__ void i8_body(const I8Maps& p) {
  using L = I8Smem<F32, MT>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int KS = L::KS, N4 = MT / 2;
  constexpr bool PREP = F32;
  extern __shared__ __align__(128) unsigned char i8_smem[];
  __shared__ int last;
  unsigned char* sp = smem_1024(i8_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t bars = su + L::BARS;
  const Ring<I8_ST> ring{bars, PREP ? bars + 8 * I8_ST : 0u, bars + 16 * I8_ST};
  const I8Args& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nt = blockIdx.x, mt = blockIdx.y, z = blockIdx.z;
  const int n0 = nt * I8_BN, m0 = mt * MT;
  const int kbeg = z * a.per, kend = min(a.K, kbeg + a.per);
  const int units = (kend - kbeg + KS - 1) / KS;
  if (tid == 0) {
    ring.init(GEMM_PREP);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - CONSUMERS;
    if (pw == 0) {
      for (int u = 0; u < units; ++u) {
        const uint32_t base = su + ring.acquire(u) * L::STAGE, bar = ring.full_bar(u);
        const int k = kbeg + u * KS;
        mbar_expect_tx(bar, L::WT + L::XT);
        tma_load(base, &p.w, bar, n0, k, 0);
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
          tma_load(base + L::WT + bx * MT * 128, &p.x, bar, k + bx * (KS / 2), m0, 0);
      }
    } else if (PREP && pw >= 32) {
      const int pt = pw - 32;
      for (int u = 0; u < units; ++u) {
        split_x<MT>(sp + ring.wait_full(u) * L::STAGE + L::WT, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        ring.arrive_ready(u);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / WG_THREADS, wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  // the weight's ldmatrix.trans: lane 8 j + r names k row 32 q + 8 j + r at
  // the warp's 16 columns, 16-byte chunk 4 wg + wq of the row
  const int wch = 4 * wg + wq;
  float acc[N4], comp[N4];   // f32: the running sum and its compensation
  zero(acc);
  zero(comp);
  for (int u = 0; u < units; ++u) {
    const int s = PREP ? ring.wait_ready(u) : ring.wait_full(u);
    const uint32_t base = su + s * L::STAGE, xt = base + L::WT;
    // each 32 k rows' A fragments widened and their products issued before
    // the next 32 rows are read, so that widening overlaps the tensor core
    uint32_t av[KS / (F32 ? 8 : 16)][4];
    float tile[N4];                         // bf16: the stage's product; f32: x2, x3's
    float tl[F32 ? KS / 16 : 1][N4];        // f32: x1's products, a fresh tile per 16 k
    zero(tile);
    reg_fence(tile);
#pragma unroll
    for (int j = 0; j < (F32 ? KS / 16 : 1); ++j) {
      zero(tl[j]);
      reg_fence(tl[j]);
    }
#pragma unroll
    for (int q = 0; q < KS / 32; ++q) {
      const int row = 32 * q + lane;
      uint32_t r[4];
      ldmatrix4_trans(r, base + row * 128 + ((wch ^ (row & 7)) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] ^= 0x80808080u;
      if constexpr (F32) {
        // k-step 4 q + j: slots t, t + 4 hold k rows 2 t, 2 t + 1 of its 8.
        // Its two small passes (w x3, w x2) go to the stage's small tile, and
        // w x1 to tile 2 q + j / 2, two of the tensor core's rounding adds
        // per 16 k at the size of the large terms
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) av[4 * q + j][i] = __float_as_uint(i8_f32(r[j], i));
        reg_fence(av);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * (4 * q + j);
          wgmma_tf32(tile, av[4 * q + j], desc_f32<MT>(xt + 2 * L::XT, c));
          wgmma_tf32(tile, av[4 * q + j], desc_f32<MT>(xt + L::XT, c));
          wgmma_tf32(tl[2 * q + j / 2], av[4 * q + j], desc_f32<MT>(xt, c));
        }
      } else {
        // k-steps 2 q and 2 q + 1: rows 2 t, 2 t + 1 (and + 8) of their 16
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t v = r[2 * h + e];
            av[2 * q + h][2 * e] = i8_bf16x2(i8_f32(v, 0), i8_f32(v, 2));
            av[2 * q + h][2 * e + 1] = i8_bf16x2(i8_f32(v, 1), i8_f32(v, 3));
          }
        reg_fence(av);
        wg_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = 2 * q + h;
          wgmma_rs_k(tile, av[kk], desc_sw128(xt + (kk >> 2) * MT * 128, 32 * (kk & 3)), 1);
        }
      }
    }
    wg_commit();
    wg_wait();
    reg_fence(av);
    if constexpr (F32) {
      // the tiles join the sum, x1's in k order and then the small one,
      // compensated (Kahan: acc - comp carries the sum)
      reg_fence(tile);
#pragma unroll
      for (int j = 0; j <= KS / 16; ++j) {
        if (j < KS / 16) reg_fence(tl[j]);
#pragma unroll
        for (int i = 0; i < N4; ++i) {
          const float yv = (j < KS / 16 ? tl[j][i] : tile[i]) - comp[i], tv = acc[i] + yv;
          comp[i] = (tv - acc[i]) - yv;
          acc[i] = tv;
        }
      }
    } else {
      reg_fence(tile);
      add_tile(acc, tile);
    }
    ring.release(u, lane);
  }

  const int nr = n0 + 64 * wg + 16 * wq + 2 * g;   // this thread's columns nr, nr + 1
  auto at = [&](int i) -> long long {
    const int n = nr + ((i >> 1) & 1), m = m0 + 8 * (i >> 2) + 2 * t + (i & 1);
    return m < a.M && n < a.N ? (long long)m * a.N + n : -1;
  };
  const int per_tile = a.splits > I8_GROUP ? (a.splits + I8_GROUP - 1) / I8_GROUP + 1 : 1;
  int* count = a.counts + (mt * gridDim.x + nt) * per_tile;
  T* y = static_cast<T*>(a.y);
  if constexpr (F32) {
    // the compensated sum as one f64 (acc - comp), the splits' partials added
    // in f64, and y rounded once, after the scale: as the exact product
    double sum[N4];
#pragma unroll
    for (int i = 0; i < N4; ++i) sum[i] = (double)acc[i] - (double)comp[i];
    if (a.splits > 1 &&
        !splitk_sum<32, I8_GROUP>(sum, static_cast<double*>(a.part), (size_t)a.M * a.N, z,
                                  a.splits, count, &last, at))
      return;
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const long long o = at(i);
      if (o >= 0) y[o] = (float)(sum[i] * (double)a.scale[nr + ((i >> 1) & 1)]);
    }
  } else {
    if (a.splits > 1 &&
        !splitk_sum<32, I8_GROUP>(acc, static_cast<float*>(a.part), (size_t)a.M * a.N, z,
                                  a.splits, count, &last, at))
      return;
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const long long o = at(i);
      if (o >= 0) y[o] = from_f32<T>(acc[i] * a.scale[nr + ((i >> 1) & 1)]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(GEMM_THREADS, 1) i8_f32_kernel(const __grid_constant__ I8Maps p) {
  i8_body<true, MT>(p);
}

template <int MT>
__global__ void __launch_bounds__(GEMM_THREADS, 1) i8_bf16_kernel(const __grid_constant__ I8Maps p) {
  i8_body<false, MT>(p);
}

template <bool F32, int MT>
int launch_mt(const void* x, const void* w, const void* scale, void* y, void* part, void* counts,
              int M, int N, int K, int ldx, int ldw, int per, int splits, cudaStream_t s) {
  using L = I8Smem<F32, MT>;
  I8Maps p = {};
  I8Args& q = p.a;
  q.scale = static_cast<const float*>(scale);
  q.y = y;
  q.part = part;
  q.counts = static_cast<int*>(counts);
  q.M = M;
  q.N = N;
  q.K = K;
  q.per = per;
  q.splits = splits;
  if (!tma_map_sw128(&p.x, x, F32, ldx, M, 1, MT, 1) ||
      !tma_map(&p.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ldw, K, 1, 128, L::KS, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + I8_BN - 1) / I8_BN, (M + MT - 1) / MT, splits);
  if (F32) return launch_kernel(i8_f32_kernel<MT>, grid, GEMM_THREADS, L::BYTES, s, p);
  return launch_kernel(i8_bf16_kernel<MT>, grid, GEMM_THREADS, L::BYTES, s, p);
}

// MT: the smallest of 8, 16, 32 that holds min(M, 32) rows
template <bool F32>
int launch(const void* x, const void* w, const void* scale, void* y, void* part, void* counts,
           int M, int N, int K, int ldx, int ldw, int per, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_mt<F32, 8>(x, w, scale, y, part, counts, M, N, K, ldx, ldw, per, splits, s);
  if (M <= 16) return launch_mt<F32, 16>(x, w, scale, y, part, counts, M, N, K, ldx, ldw, per, splits, s);
  return launch_mt<F32, 32>(x, w, scale, y, part, counts, M, N, K, ldx, ldw, per, splits, s);
}

}  // namespace

extern "C" {

int int8_matmul_kc(void) { return I8_KC; }
int int8_matmul_tile_n(int) { return I8_BN; }   // both dtypes

// x [M, ldx] (zero past K), w [K, ldw] int8 (zero past N), scale [N] f32;
// y [M, N]; part and counts (zeros) as gemm_sm90.cuh's splitk_sum takes them
// when splits > 1.
int int8_matmul_f32(const void* x, const void* w, const void* scale, void* y, void* part,
                    void* counts, int M, int N, int K, int ldx, int ldw, int k_per_split,
                    int splits, void* stream) {
  return launch<true>(x, w, scale, y, part, counts, M, N, K, ldx, ldw, k_per_split, splits,
                      stream);
}

int int8_matmul_bf16(const void* x, const void* w, const void* scale, void* y, void* part,
                     void* counts, int M, int N, int K, int ldx, int ldw, int k_per_split,
                     int splits, void* stream) {
  return launch<false>(x, w, scale, y, part, counts, M, N, K, ldx, ldw, k_per_split, splits,
                       stream);
}

}  // extern "C"
