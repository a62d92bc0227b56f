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
// stages (C = Cout from 64 to 512) it is bound by operations, on the tensor
// cores: in f32 three TF32 passes a product (the JAX kernel asks for
// Precision.HIGHEST; 165 TFLOP/s of f32-accurate work, the CUDA cores' FMA
// peak is 67), in bf16 989 TFLOP/s.
//
// What the design does about it: an implicit GEMM on wgmma fed by TMA, with
// M = N*H*W output pixels, K = 9C (tap-major: k = (3 di + dj) C + c, HWIO
// read as [9C, Cout]) and N = Cout.  A block owns 128 consecutive output
// pixels (rows and images may change inside them) and 64 output channels,
// and walks K as channel chunks of 128 bytes (64 bf16, 32 f32) times the 9
// taps.  One producer warpgroup and two consumer warpgroups of 64 pixels:
//   * A, the TPU's tiled body rethought: per chunk, three bands of 136 input
//     pixels come in once by TMA (the flattened pixels m0 + di W - 1 .. for
//     di = -1, 0, 1; rows past the tensor read as zeros), and the prep warps
//     apply the BN fold once per input pixel in place, only to pixels of the
//     tensor (bf16: folded in f32, rounded to bf16 as before).  The 9 taps
//     read these bands at shifted rows (tap (di, dj): band di, row r + dj
//     for output row r), which meet no 8-row alignment, so A goes to wgmma
//     from registers: one ldmatrix a k-step, each lane naming its own row's
//     swizzled address, or a row of zeros where its pixel's tap leaves the
//     image.  A is double-buffered across chunks.
//   * B: per (chunk, tap) a tile of 64 output channels by TMA through a
//     ring of 4 stages.  bf16 reads w as it is (HWIO is [9C, Cout]: the
//     tile is N-major, which bf16 wgmma takes); TF32 wgmma takes only a
//     K-major B, so in f32 the wrapper makes a [Cout, 9, C] copy, split
//     into its TF32 hi and lo halves.
//   * f32: every product in three TF32 passes (flash_attention_sm90.cuh: A
//     split in registers, B's halves from the wrapper), each tap's product
//     in a fresh accumulator added to y in f32: the tensor core's adds round
//     toward zero, and chained over K = 9C that bias would reach the f32
//     limit.  bf16: one pass, chained.
//   * Split-K: where the (pixel, channel) tiles cannot fill the card's 132
//     SMs, the chunks are split over gridDim.z blocks (conv3_bn.py's plan
//     picks the count).  Each writes its f32 partial tile; the last of them
//     to finish (an arrival count per tile) adds all partials in split order,
//     so y repeats bit for bit.
//   * The epilogue writes y from registers and sums the f32 accumulator
//     (not the rounded y) per column over the tile's pixels, in a fixed
//     order; the last tile of each group of 32 pixel tiles adds their sums,
//     and the last group of each column block the groups' (arrival counts
//     again; two levels, so that no one block reads thousands of rows),
//     each in a fixed order: s1 and s2 come out of the one launch and
//     repeat bit for bit.
//   * bf16 keeps one unit's products (a tap of a chunk) in flight while the
//     next unit's A loads; f32, whose fresh tile must land before it is
//     added, waits for each unit.
// The GEMM core (the block's warpgroups and rings, the split-K sum, the
// column sums, the BatchNorm fold; gemm_sm90.cuh) is shared with
// matmul_bn_act.cu, matmul_bn_act_bwd.cu and int8_matmul.cu; the Hopper
// pieces below it (mbarriers, TMA, wgmma, the TF32 split) are the flash
// kernels' (flash_attention.cuh, flash_attention_sm90.cuh).
//
// Requirements checked and met by the Python wrapper (conv3_bn.py): x
// contiguous [M', C'] with C' a multiple of the chunk and M' >= 136 rows
// (zero-padded copies where C or M fall short), a, b padded to C' with
// zeros, w (bf16: HWIO [3, 3, C', Cout']; f32: the copies [Cout', 9, C'])
// with Cout' a multiple of 64, and
// the scratch of its plan: partials [S, M, Cout] when S > 1, the sums
// [2, tiles_m + groups, Cout], and zeroed arrival counts.  Every entry point returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for tensor maps
// the CUDA driver refuses).

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int C3_BM = 128, C3_BN = GEMM_BN;   // output pixels and channels of a block
constexpr int C3_BAND = 136;                  // input pixels of a band: BM + 2, to 8
constexpr int C3_BAND_BYTES = C3_BAND * 128;  // 17408: a multiple of 1024
constexpr int C3_ST = 4;                      // B stages

struct C3Args {
  const float* a;       // [C'] or null (no prologue)
  const float* b;       // [C']
  void* y;              // [M, Cout]
  float* part;          // [S, M, Cout]: split-K partials (S > 1)
  float* stats;         // [2, tiles_m + groups, Cout]: column sums of y, y^2 of each
                        // pixel tile, then of each group of GEMM_GROUP tiles
  int* counts;          // zeros: [tiles_m * tiles_n] (S > 1), [tiles_n * groups], [tiles_n]
  float* s1;            // [Cout]
  float* s2;            // [Cout]
  int M, H, W, C, Cout, chunks, splits, tiles_m, tiles_n, relu_in;
};

struct alignas(64) C3Maps {
  CUtensorMap x;        // [1, M', C'], boxes [1, 136, 128 bytes]
  CUtensorMap w, w_lo;  // f32: [Cout', 9, C'], boxes [64, 1, 128 bytes], hi and lo halves;
                        // bf16: HWIO as [1, 9C', Cout'], boxes [1, 64, 128 bytes]
  C3Args a;
};

// Shared memory: two A buffers of three bands, the B ring (f32: hi | lo),
// a 16-byte row of zeros, the column sums of the consumer warps, barriers.
template <bool F32>
struct C3Smem {
  static constexpr int CK = F32 ? 32 : 64;                      // channels of a chunk
  static constexpr int A_BUF = 3 * C3_BAND_BYTES;
  static constexpr int B_TILE = C3_BN * 128, B_STAGE = (F32 ? 2 : 1) * B_TILE;
  static constexpr int A0 = 0, B0 = 2 * A_BUF, ZERO = B0 + C3_ST * B_STAGE;
  static constexpr int RED = ZERO + 128;                        // [2][8 warps][BN] f32
  static constexpr int BARS = RED + 2 * 8 * C3_BN * 4;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (6 + 2 * C3_ST);
};

// prep: the fold applied in place to one A buffer (3 bands of 136 pixels x
// 128 bytes, 128-byte swizzled), to the pixels of the tensor only.  Thread
// pt takes the 16-byte chunks pt, pt + GEMM_PREP, ...: always the same logical
// chunk of a row (GEMM_PREP % 8 == 0), so the same channels.
template <bool F32>
__device__ __forceinline__ void c3_fold_bands(unsigned char* buf, const C3Args& p, int c0,
                                              int m0, int pt) {
  constexpr int PER = F32 ? 4 : 8;             // channels of a 16-byte chunk
  const int j = pt & 7, c = c0 + PER * j;
  float fa[PER], fb[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    fa[e] = p.a[c + e];
    fb[e] = p.b[c + e];
  }
  for (int i = pt; i < 3 * C3_BAND * 8; i += GEMM_PREP) {
    const int row = i >> 3, di = row / C3_BAND;
    const int pix = m0 + (di - 1) * p.W - 1 + (row - di * C3_BAND);
    if (pix < 0 || pix >= p.M) continue;
    uint4* at = reinterpret_cast<uint4*>(buf + row * 128 + ((j ^ (row & 7)) << 4));
    uint4 v = *at;
    if constexpr (F32) {
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = xhat_of(f[e], fa[e], fb[e], p.relu_in);
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(xhat_of(f.x, fa[2 * e], fb[2 * e], p.relu_in),
                                     xhat_of(f.y, fa[2 * e + 1], fb[2 * e + 1], p.relu_in));
      }
    }
    *at = v;
  }
}

// One block: pixels [m0, m0 + 128) (blockIdx.y), channels [n0, n0 + 64)
// (blockIdx.x) and the chunks of split blockIdx.z, [z chunks / S, (z + 1)
// chunks / S).  Consumer warpgroup wg owns pixels m0 + 64 wg .. + 63: the
// accumulator entry 4 j + 2 h + e of lane 4 g + t of its warp wq is pixel
// m0 + 64 wg + 16 wq + g + 8 h, channel n0 + 8 j + 2 t + e.
template <bool F32>
__device__ __forceinline__ void c3_body(const C3Maps& p) {
  using L = C3Smem<F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int CK = L::CK;
  extern __shared__ __align__(128) unsigned char c3_smem[];
  __shared__ int last;
  unsigned char* sp = smem_1024(c3_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t a_full = su + L::BARS, a_ready = a_full + 16, a_empty = a_ready + 16,
                 b_full = a_empty + 16, b_empty = b_full + 8 * C3_ST;
  const Ring<2> ar{a_full, a_ready, a_empty};       // A: the bands of a chunk
  const Ring<C3_ST> br{b_full, 0, b_empty};         // B: the weights of a (chunk, tap)
  const C3Args& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nt = blockIdx.x, mt = blockIdx.y, z = blockIdx.z;
  const int m0 = mt * C3_BM, n0 = nt * C3_BN;
  const int c_begin = z * a.chunks / a.splits, n_chunks = (z + 1) * a.chunks / a.splits - c_begin;
  if (tid == 0) {
    ar.init(GEMM_PREP);
    br.init(0);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) reinterpret_cast<float*>(sp + L::ZERO)[tid] = 0.f;
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - CONSUMERS;
    if (pw == 0) {
      // the weight tiles of every (chunk, tap) in the consumers' order
      int u = 0;
      for (int ci = 0; ci < n_chunks; ++ci)
        for (int tap = 0; tap < 9; ++tap, ++u) {
          const int s = br.acquire(u);
          const uint32_t dst = su + L::B0 + s * L::B_STAGE, bar = br.full_bar(u);
          mbar_expect_tx(bar, L::B_STAGE);
          const int c0 = (c_begin + ci) * CK;
          if constexpr (F32) {
            tma_load(dst, &p.w, bar, c0, tap, n0);
            tma_load(dst + L::B_TILE, &p.w_lo, bar, c0, tap, n0);
          } else {
            tma_load(dst, &p.w, bar, n0, tap * a.C + c0, 0);
          }
        }
    } else if (pw >= 32) {
      // prep: each chunk's three bands (its first thread issues the loads),
      // folded in place
      const int pt = pw - 32;
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int ab = ci & 1, c0 = (c_begin + ci) * CK;
        const uint32_t buf = su + L::A0 + ab * L::A_BUF;
        ar.acquire(ci);
        if (pt == 0) {
          mbar_expect_tx(ar.full_bar(ci), L::A_BUF);
#pragma unroll
          for (int di = 0; di < 3; ++di)
            tma_load(buf + di * C3_BAND_BYTES, &p.x, ar.full_bar(ci), c0,
                     m0 + (di - 1) * a.W - 1, 0);
        }
        ar.wait_full(ci);
        if (a.a != nullptr) c3_fold_bands<F32>(sp + L::A0 + ab * L::A_BUF, a, c0, m0, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        ar.arrive_ready(ci);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / WG_THREADS, wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  // the pixel whose row this lane names to ldmatrix, and the taps of it
  // that stay inside its image (bit 3 di + dj)
  const int lrow = 64 * wg + 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1), k8 = lane >> 4;
  uint32_t taps = 0;
  {
    const int pix = m0 + lrow;
    if (pix < a.M) {
      const int hw = pix % (a.H * a.W), hh = hw / a.W, ww = hw - hh * a.W;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        if ((unsigned)(hh + tap / 3 - 1) < (unsigned)a.H &&
            (unsigned)(ww + tap % 3 - 1) < (unsigned)a.W)
          taps |= 1u << tap;
    }
  }
  // unit u = 9 ci + tap: chunk ci (A buffer ci & 1, waited for at its first
  // tap) and weight stage u % C3_ST
  auto b_stage = [&](int u) { return su + L::B0 + br.wait_full(u) * L::B_STAGE; };
  // the four k-steps' A fragments of unit u by ldmatrix: this lane's row of
  // band di for tap (di, dj) is lrow + dj, or the zero row
  auto load_a = [&](int u, uint32_t (&x)[4][4]) {
    const int ci = u / 9, tap = u - 9 * ci;
    const uint32_t buf = su + L::A0 + (ci & 1) * L::A_BUF;
    if (tap == 0) ar.wait_ready(ci);
    const int row = lrow + tap % 3;
    const uint32_t rbase = buf + (tap / 3) * C3_BAND_BYTES + row * 128;
    const bool on = (taps >> tap) & 1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix4(x[kk], on ? rbase + (((2 * kk + k8) ^ (row & 7)) << 4) : su + L::ZERO);
  };
  // unit u's products are done: its weight stage, and after the last tap
  // its A buffer, go back to the producers
  auto retire = [&](int u) {
    __syncwarp();
    if (lane == 0) {
      br.arrive_empty(u);
      if (u % 9 == 8) ar.arrive_empty(u / 9);
    }
  };
  const int units = 9 * n_chunks;
  float acc[32];
  zero(acc);
  if constexpr (F32) {
    // four 8-channel k-steps a unit, three TF32 passes, into a fresh tile
    for (int u = 0; u < units; ++u) {
      uint32_t x[4][4], ah[4][4], al[4][4];
      load_a(u, x);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[kk][i]), ah[kk][i], al[kk][i]);
      const uint32_t bs = b_stage(u);
      float tile[32];
      zero(tile);
      reg_fence(tile);
      reg_fence(ah);
      reg_fence(al);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma3(tile, ah[kk], al[kk], desc_f32<C3_BN>(bs, 8 * kk),
             desc_f32<C3_BN>(bs + L::B_TILE, 8 * kk));
      wg_commit();
      wg_wait();
      reg_fence(tile);
      reg_fence(ah);
      reg_fence(al);
      add_tile(acc, tile);
      retire(u);
    }
  } else {
    // four 16-channel k-steps a unit, one pass chained in acc, one unit's
    // products in flight while the next unit's A loads (two register sets)
    uint32_t a0[4][4] = {}, a1[4][4] = {};
    auto issue = [&](int u, uint32_t (&a)[4][4]) {
      load_a(u, a);
      const uint32_t bs = b_stage(u);
      reg_fence(acc);
      reg_fence(a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, a[kk], desc_n<64, 64>(bs, 16 * kk, 0), 1);
      wg_commit();
    };
    for (int u = 0; u < units; u += 2) {
      issue(u, a0);
      wg_wait1();
      reg_fence(a1);             // unit u - 1 is done with a1
      if (u > 0) retire(u - 1);
      if (u + 1 < units) {
        issue(u + 1, a1);
        wg_wait1();
        reg_fence(a0);           // unit u is done with a0
        retire(u);
      }
    }
    wg_wait();
    reg_fence(acc);
    reg_fence(a0);
    reg_fence(a1);
    if (units > 0) retire(units - 1);
  }

  const int pix0 = m0 + 64 * wg + 16 * wq + g;   // this thread's pixels pix0, pix0 + 8
  if (a.splits > 1) {
    // this split's partial tile; the last split of the tile to arrive adds
    // them all in split order (few splits: one level, entry by entry, as
    // gemm_sm90.cuh's splitk_sum at width 1, without its second level,
    // which the conv's registers would pay for)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pix0 + 8 * h >= a.M) continue;
      float* row = a.part + ((size_t)z * a.M + pix0 + 8 * h) * a.Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + 8 * j + 2 * t + e < a.Cout) row[n0 + 8 * j + 2 * t + e] = acc[4 * j + 2 * h + e];
    }
    if (!last_to_arrive(a.counts + mt * a.tiles_n + nt, a.splits, &last)) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pix0 + 8 * h >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t + e;
          if (col >= a.Cout) continue;
          float sum = 0.f;
          for (int sp2 = 0; sp2 < a.splits; ++sp2)
            sum += __ldcg(a.part + ((size_t)sp2 * a.M + pix0 + 8 * h) * a.Cout + col);
          acc[4 * j + 2 * h + e] = sum;
        }
    }
  }

  // y, and the tile's column sums of the f32 accumulator over its pixels
  T* y = static_cast<T*>(a.y);
  float c1[16], c2[16];   // channel n0 + 8 j + 2 t + e at 2 j + e
#pragma unroll
  for (int i = 0; i < 16; ++i) c1[i] = c2[i] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pix = pix0 + 8 * h;
    if (pix >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * t + e;
        const float v = acc[4 * j + 2 * h + e];
        if (col < a.Cout) {
          if constexpr (F32)
            y[(size_t)pix * a.Cout + col] = v;
          else
            y[(size_t)pix * a.Cout + col] = __float2bfloat16_rn(v);
        }
        c1[2 * j + e] += v;
        c2[2 * j + e] += v * v;
      }
  }
  // the column sums over the tile's pixels, then over the pixel tiles
  const ColSums cs{a.stats, a.counts + (a.splits > 1 ? a.tiles_m * a.tiles_n : 0), a.s1, a.s2,
                   a.Cout, a.tiles_m, a.tiles_n};
  col_sums(c1, c2, reinterpret_cast<float*>(sp + L::RED), cs, mt, nt, &last);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) c3_f32_kernel(const __grid_constant__ C3Maps p) {
  c3_body<true>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) c3_bf16_kernel(const __grid_constant__ C3Maps p) {
  c3_body<false>(p);
}

template <bool F32>
int launch(const void* x, const void* w, const void* w_lo, const void* a, const void* b,
           void* y, void* part, void* stats, void* counts, void* s1, void* s2, int n_img,
           int H, int W, int C, int x_rows, int Cout, int cout_rows, int splits, int relu_in,
           void* stream) {
  using L = C3Smem<F32>;
  C3Maps p;
  C3Args& q = p.a;
  q.a = static_cast<const float*>(a);
  q.b = static_cast<const float*>(b);
  q.y = y;
  q.part = static_cast<float*>(part);
  q.stats = static_cast<float*>(stats);
  q.counts = static_cast<int*>(counts);
  q.s1 = static_cast<float*>(s1);
  q.s2 = static_cast<float*>(s2);
  q.M = n_img * H * W;
  q.H = H;
  q.W = W;
  q.C = C;
  q.Cout = Cout;
  q.chunks = C / L::CK;
  q.splits = splits;
  q.tiles_m = (q.M + C3_BM - 1) / C3_BM;
  q.tiles_n = (Cout + C3_BN - 1) / C3_BN;
  q.relu_in = relu_in;
  if (!(tma_map_sw128(&p.x, x, F32, C, x_rows, 1, C3_BAND, 1) &&
        (F32 ? tma_map_sw128(&p.w, w, F32, C, 9, cout_rows, 1, C3_BN) &&
                   tma_map_sw128(&p.w_lo, w_lo, F32, C, 9, cout_rows, 1, C3_BN)
             : tma_map_sw128(&p.w, w, F32, cout_rows, 9 * C, 1, 64, 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(q.tiles_n, q.tiles_m, splits);
  return launch_kernel(F32 ? c3_f32_kernel : c3_bf16_kernel, grid, GEMM_THREADS, L::BYTES,
                       reinterpret_cast<cudaStream_t>(stream), p);
}

}  // namespace

extern "C" {

// The tile and chunk sizes the wrapper's plan must use.
int conv3x3_bn_act_tile_m(void) { return C3_BM; }
int conv3x3_bn_act_tile_n(void) { return C3_BN; }
int conv3x3_bn_act_chunk(int f32) { return f32 ? C3Smem<true>::CK : C3Smem<false>::CK; }

// x [x_rows, C] (C a multiple of the chunk); f32: w and w_lo [cout_rows, 9,
// C]; bf16: w [3, 3, C, cout_rows]; the rest as C3Args.
int conv3x3_bn_act_f32(const void* x, const void* w, const void* w_lo, const void* a,
                       const void* b, void* y, void* part, void* stats, void* counts, void* s1,
                       void* s2, int n_img, int H, int W, int C, int x_rows, int Cout,
                       int cout_rows, int splits, int relu_in, void* stream) {
  return launch<true>(x, w, w_lo, a, b, y, part, stats, counts, s1, s2, n_img, H, W, C, x_rows,
                      Cout, cout_rows, splits, relu_in, stream);
}

int conv3x3_bn_act_bf16(const void* x, const void* w, const void* a, const void* b, void* y,
                        void* part, void* stats, void* counts, void* s1, void* s2, int n_img,
                        int H, int W, int C, int x_rows, int Cout, int cout_rows, int splits,
                        int relu_in, void* stream) {
  return launch<false>(x, w, nullptr, a, b, y, part, stats, counts, s1, s2, n_img, H, W, C,
                       x_rows, Cout, cout_rows, splits, relu_in, stream);
}

}  // extern "C"
