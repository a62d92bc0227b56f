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
// blocks run in parallel in no order, so the one TPU kernel becomes two
// launches, each summing across blocks in a fixed order in the same launch.
//
// What bounds it on the H100: 4 M K N operations (two products) against
// 2 M K + 2 M N + 2 K N elements moved.  f32 runs every product in three
// TF32 passes (the JAX kernel asks for Precision.HIGHEST: 165 TFLOP/s of
// f32-accurate work on the tensor cores, where the CUDA cores' FMA peak is
// 67), and ResNet-50's shapes are bound by those operations; bf16 (989
// TFLOP/s) is bound by the bytes of x, y, dy and dx at most shapes.
//
// What the design does about it: both kernels run on the GEMM core of
// gemm_sm90.cuh (one producer warpgroup: a TMA thread and 96 prep threads;
// two consumer warpgroups of 64 output rows; wgmma fed by TMA through a ring
// of stages; f32 as three TF32 passes, each stage's product in a fresh tile
// added in f32, since the tensor core's adds round toward zero):
//
//   * dx kernel, grid (K / 128, M / 128), contracting N in 128-byte chunks.
//     A = dyt: the dy and y tiles and the chunk of ds1 and ds2 come by TMA,
//     and each consumer lane forms its A fragment from them in registers
//     (ldmatrix, then dyt per element with the plain version's rounding
//     points; f32 split into TF32 hi and lo there).  B = W: [K, N] row-major
//     is K-major for this product, as TF32 wgmma needs; in f32 the prep
//     threads split each W tile in place into hi and lo.  f32 takes the
//     block's 128 columns as two halves of 64, each product in a fresh tile.
//     The epilogue recomputes pre from x at the same (row, column), applies
//     the relu mask, writes dx and adds da and db over the block's rows,
//     then over the M tiles in a fixed order (arrival counts, two levels:
//     the column sums of gemm_sm90.cuh, in blocks of 64 columns).
//   * dW kernel, grid (N / 128, K / 128, splits), contracting M in steps of
//     32 (f32) or 64 (bf16) rows.  A = xhat^T from an x tile by TMA: A
//     reaches wgmma transposed from registers (bf16: ldmatrix.trans; f32:
//     read per lane and split), and each lane folds its elements there
//     (x*a + b, relu; zeros past M, so that act(b) never enters): a lane's
//     rows of K are fixed, so a and b sit in its registers, and each
//     element is folded once.  B = dyt: bf16 takes it N-major as the prep
//     threads write it in place into the dy tile; TF32 takes only a K-major
//     B, so in f32 the prep threads write dyt transposed into hi and lo
//     tiles, from dy and y tiles of a ring of their own that they release
//     as soon as they have read them.  M splits over blocks where the (K,
//     N) tiles cannot fill one wave of the card's SMs (conv_bn.bwd_plan);
//     each split writes its f32 partial, and the last split of a tile to
//     arrive adds them in a fixed order (two levels past 8 splits) and
//     writes dW.
//
// Rows past M add nothing: the TMA gives zeros past the tensors, and zeros
// are written where a fold or dyt would not give them (act(b), ds1); dx is
// not stored for them.  Any K and N: tiles past them read zeros
// and nothing past them is written.
//
// Requirements checked and met by the Python wrapper (conv_bn.py):
// contiguous row-major tensors whose rows (ldx, ldw, ldn elements of x, W
// and dy/y: zero-padded copies where a row's bytes are no multiple of 16)
// and base pointers are 16-byte aligned; ds1, ds2 f32 [N]; the scratch of
// its plan (partials [splits, K, N] when splits > 1, the column-sum tables
// [2, tiles_m + groups, K], zeroed arrival counts); M / 128 < 65536.  Every
// entry point returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for tensor maps the CUDA driver refuses).

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int DX_BM = 128, DX_BN = 128;   // dx block: rows of M, columns of K (two column-sum blocks)
constexpr int DW_BK = 128, DW_BN = 128;   // dW block: rows of K, columns of N
constexpr int SPLIT_GROUP = 8;            // dW's M splits summed first in groups of this many

struct MbbArgs {
  const void* x;        // [M, ldx] (the dx epilogue's pre)
  const float* a;       // [K] or null (no prologue)
  const float* b;       // [K]
  const float* ds1;     // [N]
  const float* ds2;     // [N]
  void* dx;             // [M, K]
  void* dw;             // [K, N]
  float* da;            // [K]
  float* db;            // [K]
  float* part;          // [splits (+ groups), K, N] (splits > 1)
  float* stats;         // [2, tiles_m + groups, K]: da, db column sums
  int* counts;          // zeros: dx's column sums, then dW's per tile (splits > 1)
  int* dw_counts;       // counts + 2 tiles_kx * (groups + 1)
  int M, N, K, ldx, splits, steps, relu_in;
};

struct alignas(64) MbbMaps {
  CUtensorMap x;        // [M, ldx]: boxes [one M step, 128 bytes] (dW)
  CUtensorMap w;        // [K, ldw]: boxes [128 rows, 128 bytes] (dx)
  CUtensorMap dy, y;    // [M, ldn]: boxes as x's
  CUtensorMap ds1, ds2; // [N] f32: boxes of one N chunk (dx)
  MbbArgs a;
};

// dy + ds1 + 2 y ds2, each step rounded as the plain version rounds it
__device__ __forceinline__ float dy_total(float dy, float y, float ds1, float ds2) {
  return __fadd_rn(__fadd_rn(dy, ds1), __fmul_rn(__fmul_rn(2.f, y), ds2));
}

// ------------------------------------------------------------ dx kernel
// Shared memory: ST stages of the dy and y tiles [128 rows, CK], the W tile
// [128 rows, CK] (f32: hi | lo) and ds1, ds2 [CK]; the column sums of the
// consumer warps; barriers.
template <bool F32>
struct DxSmem {
  static constexpr int CK = F32 ? 32 : 64;                 // N columns of a stage
  static constexpr int ST = F32 ? 3 : 4;
  static constexpr int A_TILE = DX_BM * 128, B_TILE = DX_BN * 128;
  static constexpr int DS0 = 2 * A_TILE + (F32 ? 2 : 1) * B_TILE;
  static constexpr int STAGE = DS0 + 1024;
  static constexpr int TX = 2 * A_TILE + B_TILE + 2 * CK * 4;   // the TMA's bytes of a stage
  static constexpr int RED = ST * STAGE;
  static constexpr int BARS = RED + 2 * 8 * GEMM_BN * 4;
  static constexpr size_t BYTES = 1024 + BARS + 8 * 3 * ST;
};

// One block: rows [m0, m0 + 128) (blockIdx.y), columns [k0, k0 + 128) of K
// (blockIdx.x), all of N.  Consumer warpgroup wg owns rows m0 + 64 wg ..
// + 63: accumulator entry 4 j + 2 h + e of lane 4 g + t of its warp wq is row
// m0 + 64 wg + 16 wq + g + 8 h, column k0 + 8 j + 2 t + e (j < 16).  f32
// takes the two 64-column halves in turn, each in a fresh tile.
template <bool F32>
__device__ __forceinline__ void dx_body(const MbbMaps& p) {
  using L = DxSmem<F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int CK = L::CK, ST = L::ST;
  extern __shared__ __align__(128) unsigned char mbb_smem[];
  __shared__ int last;
  unsigned char* sp = smem_1024(mbb_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t bars = su + L::BARS;
  const Ring<ST> ring{bars, F32 ? bars + 8 * ST : 0u, bars + 16 * ST};
  const MbbArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int kt = blockIdx.x, mt = blockIdx.y;
  const int m0 = mt * DX_BM, k0 = kt * DX_BN;
  const int chunks = (a.N + CK - 1) / CK;
  const bool pro = a.a != nullptr;
  if (tid == 0) {
    ring.init(GEMM_PREP);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - CONSUMERS;
    if (pw == 0) {
      for (int u = 0; u < chunks; ++u) {
        const uint32_t base = su + ring.acquire(u) * L::STAGE, bar = ring.full_bar(u);
        const int n = u * CK;
        mbar_expect_tx(bar, L::TX);
        tma_load(base, &p.dy, bar, n, m0, 0);
        tma_load(base + L::A_TILE, &p.y, bar, n, m0, 0);
        tma_load(base + 2 * L::A_TILE, &p.w, bar, n, k0, 0);
        tma_load(base + L::DS0, &p.ds1, bar, n, 0, 0);
        tma_load(base + L::DS0 + CK * 4, &p.ds2, bar, n, 0, 0);
      }
    } else if (F32 && pw >= 32) {
      // prep: each W tile split into TF32 hi (in place) and lo
      const int pt = pw - 32;
      for (int u = 0; u < chunks; ++u) {
        unsigned char* wt = sp + ring.wait_full(u) * L::STAGE + 2 * L::A_TILE;
        split_in_place(wt, wt + L::B_TILE, L::B_TILE, pt, GEMM_PREP);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        ring.arrive_ready(u);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / WG_THREADS, wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * wq;   // the warp's first row of the tile
  float acc[64];
  zero(acc);
  if constexpr (F32) {
    // four 8-column k-steps a stage, three TF32 passes a half into a fresh
    // tile; A(row r0 + g + 8 (i & 1), column t + 4 (i >> 1)) in register i
    // (flash_attention_sm90.cuh's a_split_rows), dyt formed and split here
    const int j8 = lane >> 3, lr = r0 + (lane & 7) + 8 * (j8 & 1);
    const bool two = k0 + 64 < a.K;   // the second half holds columns of K
    for (int u = 0; u < chunks; ++u) {
      const int s = ring.wait_ready(u);
      const uint32_t base = su + s * L::STAGE;
      const float* ds = reinterpret_cast<const float*>(sp + s * L::STAGE + L::DS0);
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t d[4], yv[4];
        const uint32_t off = f32_at<DX_BM>(lr, 8 * kk + 4 * (j8 >> 1));
        ldmatrix4(d, base + off);
        ldmatrix4(yv, base + L::A_TILE + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * kk + t + 4 * (i >> 1);
          split_tf32(dy_total(__uint_as_float(d[i]), __uint_as_float(yv[i]), ds[c], ds[CK + c]),
                     ah[kk][i], al[kk][i]);
        }
      }
      const uint32_t wt = base + 2 * L::A_TILE;
      auto half = [&](auto hc) {
        constexpr int H = decltype(hc)::value;
        float tile[32];
        zero(tile);
        reg_fence(tile);
        reg_fence(ah);
        reg_fence(al);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(tile, ah[kk], al[kk], desc_f32<DX_BN>(wt + H * 64 * 128, 8 * kk),
               desc_f32<DX_BN>(wt + L::B_TILE + H * 64 * 128, 8 * kk));
        wg_commit();
        wg_wait();
        reg_fence(tile);
        reg_fence(ah);
        reg_fence(al);
        add_half<H>(acc, tile);
      };
      half(std::integral_constant<int, 0>());
      if (two) half(std::integral_constant<int, 1>());
      ring.release(u, lane);
    }
  } else {
    // four 16-column k-steps a stage (m64n128), one pass chained in acc, one
    // stage's products in flight while the next stage's A is formed (two
    // register sets); the ldmatrix rows of the bf16 A fragment, dyt formed here
    const int lrow = r0 + (lane & 7) + 8 * ((lane >> 3) & 1), k8 = lane >> 4;
    auto issue = [&](int u, uint32_t (&av)[4][4]) {
      const int s = ring.wait_full(u);
      const uint32_t base = su + s * L::STAGE;
      const float* ds = reinterpret_cast<const float*>(sp + s * L::STAGE + L::DS0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t d[4], yv[4];
        const uint32_t off = lrow * 128 + (((2 * kk + k8) ^ (lrow & 7)) << 4);
        ldmatrix4(d, base + off);
        ldmatrix4(yv, base + L::A_TILE + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * kk + 2 * t + 8 * (e >> 1);
          const float2 df = bf2(d[e]), yf = bf2(yv[e]);
          av[kk][e] = pack_bf16(dy_total(df.x, yf.x, ds[c], ds[CK + c]),
                                dy_total(df.y, yf.y, ds[c + 1], ds[CK + c + 1]));
        }
      }
      reg_fence(acc);
      reg_fence(av);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_k(acc, av[kk], desc_sw128(base + 2 * L::A_TILE, 32 * kk), 1);
      wg_commit();
    };
    uint32_t a0[4][4] = {}, a1[4][4] = {};
    for (int u = 0; u < chunks; u += 2) {
      issue(u, a0);
      wg_wait1();
      reg_fence(a1);             // stage u - 1 is done with a1
      if (u > 0) ring.release(u - 1, lane);
      if (u + 1 < chunks) {
        issue(u + 1, a1);
        wg_wait1();
        reg_fence(a0);           // stage u is done with a0
        ring.release(u, lane);
      }
    }
    wg_wait();
    reg_fence(acc);
    reg_fence(a0);
    reg_fence(a1);
    if (chunks > 0) ring.release(chunks - 1, lane);
  }

  // dpre from pre recomputed at the same (row, column) of x, dx, and the
  // da / db sums over the rows, one 64-column half at a time
  const T* x = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(a.dx);
  const bool pairs = (a.K & 1) == 0;
  const ColSums cs{a.stats, a.counts, a.da, a.db, a.K, (int)gridDim.y, 2 * (int)gridDim.x};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (k0 + 64 * hh >= a.K) continue;   // uniform over the block
    float c1[16], c2[16];   // column k0 + 64 hh + 8 j + 2 t + e at 2 j + e
#pragma unroll
    for (int i = 0; i < 16; ++i) c1[i] = c2[i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 64 * hh + 8 * j + 2 * t;
        if (col >= a.K) continue;
        float v[2] = {acc[32 * hh + 4 * j + 2 * h], acc[32 * hh + 4 * j + 2 * h + 1]};
        if (pro) {
          // x's rows are ldx >= K + 1 elements when K is odd: the pair is in them
          float xs[2];
          if constexpr (F32) {
            const float2 xv = __ldg(reinterpret_cast<const float2*>(x + (size_t)row * a.ldx + col));
            xs[0] = xv.x;
            xs[1] = xv.y;
          } else {
            const float2 xv =
                bf2(__ldg(reinterpret_cast<const unsigned int*>(x + (size_t)row * a.ldx + col)));
            xs[0] = xv.x;
            xs[1] = xv.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= a.K) continue;
            const float ak = a.a[col + e];
            if (a.relu_in && !(pre_act(xs[e], ak, a.b[col + e]) > 0.f)) v[e] = 0.f;
            c1[2 * j + e] += v[e] * xs[e];
            c2[2 * j + e] += v[e];
            v[e] = __fmul_rn(v[e], ak);
          }
        }
        T* out = dx + (size_t)row * a.K + col;
        if (pairs && col + 1 < a.K) {
          if constexpr (F32)
            *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < a.K) out[e] = from_f32<T>(v[e]);
        }
      }
    }
    if (pro) col_sums(c1, c2, reinterpret_cast<float*>(sp + L::RED), cs, mt, 2 * kt + hh, &last);
  }
}

// ------------------------------------------------------------ dW kernel
// Shared memory: ds1, ds2 at the block's 128 columns; the stages.  bf16:
// one ring of the x tile [MS rows, 128 columns of K] and the dy and y tiles
// [MS rows, 128 columns of N] (dyt in place in dy).  f32: a ring of the x
// tile and the dyt^T hi and lo tiles [128 rows of N, MS columns] that the
// consumers read, and a ring of the dy and y tiles that only prep reads and
// releases as soon as it has written dyt^T.
template <bool F32>
struct DwSmem {
  static constexpr int MS = F32 ? 32 : 64;                 // rows of M a stage takes
  static constexpr int BX = F32 ? 32 : 64;                 // columns of a box
  static constexpr int XT = MS * DW_BK * (F32 ? 4 : 2), YT = MS * DW_BN * (F32 ? 4 : 2);
  static constexpr int BT = F32 ? DW_BN * MS * 4 : 0;
  static constexpr int ST = F32 ? 3 : 4, STP = F32 ? 2 : 0;   // stages of the two rings
  static constexpr int STAGE = F32 ? XT + 2 * BT : XT + 2 * YT;
  static constexpr int PSTAGE = F32 ? 2 * YT : 0;
  static constexpr int RING0 = 1024, PRING0 = RING0 + ST * STAGE;
  static constexpr int BARS = PRING0 + STP * PSTAGE;
  static constexpr size_t BYTES = 1024 + BARS + 8 * 3 * (ST + STP);
};

// One block: rows [k0, k0 + 128) of K (blockIdx.y), columns [n0, n0 + 128)
// of N (blockIdx.x), and the M steps of split blockIdx.z, [z steps / S,
// (z + 1) steps / S).  Consumer warpgroup wg owns rows k0 + 64 wg .. + 63
// (accumulator entry 4 j + 2 h + e: row + 16 wq + g + 8 h, column n0 + 8 j +
// 2 t + e, j < 16).
template <bool F32>
__device__ __forceinline__ void dw_body(const MbbMaps& p) {
  using L = DwSmem<F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int MS = L::MS, ST = L::ST, BX = L::BX;
  extern __shared__ __align__(128) unsigned char mbb_smem[];
  __shared__ int last;
  unsigned char* sp = smem_1024(mbb_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t bars = su + L::BARS, pbars = bars + 24 * ST;
  const Ring<ST> ring{bars, bars + 8 * ST, bars + 16 * ST};
  const Ring<F32 ? L::STP : 1> pring{pbars, 0u, pbars + 16 * L::STP};
  const MbbArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nt = blockIdx.x, kt = blockIdx.y, z = blockIdx.z;
  const int n0 = nt * DW_BN, k0 = kt * DW_BK;
  const int u0 = z * a.steps / a.splits, units = (z + 1) * a.steps / a.splits - u0;
  const bool pro = a.a != nullptr;
  if (tid == 0) {
    ring.init(GEMM_PREP);
    if (F32) pring.init(0, GEMM_PREP / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - CONSUMERS;
    if (pw == 0) {
      for (int u = 0; u < units; ++u) {
        const int m = (u0 + u) * MS;
        const uint32_t base = su + L::RING0 + ring.acquire(u) * L::STAGE, bar = ring.full_bar(u);
        mbar_expect_tx(bar, F32 ? L::XT : L::XT + 2 * L::YT);
#pragma unroll
        for (int bx = 0; bx < DW_BK / BX; ++bx)
          tma_load(base + bx * MS * 128, &p.x, bar, k0 + bx * BX, m, 0);
        uint32_t ybase = base + L::XT, ybar = bar;
        if (F32) {
          ybase = su + L::PRING0 + pring.acquire(u) * L::PSTAGE;
          ybar = pring.full_bar(u);
          mbar_expect_tx(ybar, 2 * L::YT);
        }
#pragma unroll
        for (int bx = 0; bx < DW_BN / BX; ++bx) {
          tma_load(ybase + bx * MS * 128, &p.dy, ybar, n0 + bx * BX, m, 0);
          tma_load(ybase + L::YT + bx * MS * 128, &p.y, ybar, n0 + bx * BX, m, 0);
        }
      }
    } else if (pw >= 32) {
      // prep: dyt, zeros past M and N (bf16: in place in dy; f32:
      // transposed into hi and lo)
      const int pt = pw - 32;
      float* dss = reinterpret_cast<float*>(sp);   // ds1 | ds2 at the block's columns
      for (int i = pt; i < DW_BN; i += GEMM_PREP) {
        const bool on = n0 + i < a.N;
        dss[i] = on ? a.ds1[n0 + i] : 0.f;
        dss[DW_BN + i] = on ? a.ds2[n0 + i] : 0.f;
      }
      prep_sync();
      for (int u = 0; u < units; ++u) {
        unsigned char* base = sp + L::RING0 + ring.wait_full(u) * L::STAGE;
        const int m = (u0 + u) * MS;
        if constexpr (F32) {
          // dyt^T: a 16-byte chunk of dy and y (row r, columns 4 q ..) a
          // step, each of its 4 values to row 4 q + e, column r of hi and lo
          const unsigned char* yb = sp + L::PRING0 + pring.wait_full(u) * L::PSTAGE;
          unsigned char* hi = base + L::XT;
          for (int i = pt; i < MS * DW_BN / 4; i += GEMM_PREP) {
            const int r = i % MS, q = i / MS;   // neighbouring threads: neighbouring rows
            const uint32_t at = (q >> 3) * MS * 128 + r * 128 + (((q & 7) ^ (r & 7)) << 4);
            const float4 d = *reinterpret_cast<const float4*>(yb + at);
            const float4 yv = *reinterpret_cast<const float4*>(yb + L::YT + at);
            const float ds_[4] = {d.x, d.y, d.z, d.w}, ys_[4] = {yv.x, yv.y, yv.z, yv.w};
            const bool live = m + r < a.M;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 4 * q + e;
              const float v = live ? dy_total(ds_[e], ys_[e], dss[c], dss[DW_BN + c]) : 0.f;
              const float h = __uint_as_float(tf32_hi(v));
              const uint32_t to = f32_at<DW_BN>(c, r);
              *reinterpret_cast<float*>(hi + to) = h;
              *reinterpret_cast<float*>(hi + L::BT + to) = v - h;
            }
          }
          pring.release(u, lane);
        } else {
          // the thread's logical chunk lc of every row: columns 64 bx + 8 lc ..
          const int lc = pt & 7;
          float s1[2][8], s2[2][8];
#pragma unroll
          for (int bx = 0; bx < 2; ++bx)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s1[bx][e] = dss[64 * bx + 8 * lc + e];
              s2[bx][e] = dss[DW_BN + 64 * bx + 8 * lc + e];
            }
          unsigned char* dyp = base + L::XT;
          const unsigned char* yp = dyp + L::YT;
#pragma unroll 2
          for (int i = pt; i < L::YT / 16; i += GEMM_PREP) {
            const int bx = i / (MS * 8), row = (i >> 3) % MS;
            const uint32_t off = bx * MS * 128 + row * 128 + ((lc ^ (row & 7)) << 4);
            uint4 d = *reinterpret_cast<const uint4*>(dyp + off);
            const uint4 yy = *reinterpret_cast<const uint4*>(yp + off);
            __nv_bfloat162* dh = reinterpret_cast<__nv_bfloat162*>(&d);
            const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&yy);
            if (m + row < a.M) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 df = __bfloat1622float2(dh[e]), yf = __bfloat1622float2(yh[e]);
                const float v0 = bx ? dy_total(df.x, yf.x, s1[1][2 * e], s2[1][2 * e])
                                    : dy_total(df.x, yf.x, s1[0][2 * e], s2[0][2 * e]);
                const float v1 = bx ? dy_total(df.y, yf.y, s1[1][2 * e + 1], s2[1][2 * e + 1])
                                    : dy_total(df.y, yf.y, s1[0][2 * e + 1], s2[0][2 * e + 1]);
                dh[e] = __floats2bfloat162_rn(v0, v1);
              }
            } else {
              d = make_uint4(0u, 0u, 0u, 0u);
            }
            *reinterpret_cast<uint4*>(dyp + off) = d;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        ring.arrive_ready(u);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / WG_THREADS, wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * wq;   // the warp's first row of K in the block
  const bool rows = k0 + 64 * wg < a.K;   // the warpgroup's rows hold rows of K
  // the fold of this lane's two rows of K (g, g + 8): a and b, zeros past K
  // (x is zero there); applied as the lane reads its A, once per element
  float fa[2] = {0.f, 0.f}, fb[2] = {0.f, 0.f};
  if (pro) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + r0 + g + 8 * h;
      if (k < a.K) {
        fa[h] = a.a[k];
        fb[h] = a.b[k];
      }
    }
  }
  float acc[64];
  zero(acc);
  if constexpr (F32) {
    // four 8-row k-steps a stage, three TF32 passes a half into a fresh
    // tile; A = xhat^T read per lane from the x tile (register i: row of K
    // r0 + g + 8 (i & 1), row of M 8 kk + t + 4 (i >> 1)), folded and split
    // here
    const bool two = n0 + 64 < a.N;
    for (int u = 0; u < units; ++u) {
      const int s = ring.wait_ready(u);
      if (rows) {
        const unsigned char* xt = sp + L::RING0 + s * L::STAGE;
        const uint32_t hi = su + L::RING0 + s * L::STAGE + L::XT;
        const int live = a.M - (u0 + u) * MS;   // rows of the step inside M
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rm = 8 * kk + t + 4 * (i >> 1);
            float v = ld_f32(xt, f32_at<MS>(rm, r0 + g + 8 * (i & 1)));
            if (pro) v = rm < live ? xhat_of(v, fa[i & 1], fb[i & 1], a.relu_in) : 0.f;
            split_tf32(v, ah[kk][i], al[kk][i]);
          }
        auto half = [&](auto hc) {
          constexpr int H = decltype(hc)::value;
          float tile[32];
          zero(tile);
          reg_fence(tile);
          reg_fence(ah);
          reg_fence(al);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma3(tile, ah[kk], al[kk], desc_f32<DW_BN>(hi + H * 64 * 128, 8 * kk),
                 desc_f32<DW_BN>(hi + L::BT + H * 64 * 128, 8 * kk));
          wg_commit();
          wg_wait();
          reg_fence(tile);
          reg_fence(ah);
          reg_fence(al);
          add_half<H>(acc, tile);
        };
        half(std::integral_constant<int, 0>());
        if (two) half(std::integral_constant<int, 1>());
      }
      ring.release(u, lane);
    }
  } else {
    // four 16-row k-steps a stage (m64n128), one pass chained in acc, one
    // stage in flight; A = xhat^T by ldmatrix.trans: lane 8 j + r names row
    // 16 kk + r + 8 (j >> 1) of the x tile at the columns r0 + 8 (j & 1) ..
    const int j8 = lane >> 3, kc = r0 + 8 * (j8 & 1);
    const int xb = kc >> 6, ch = (kc & 63) >> 3;
    // A register e holds row of K r0 + g + 8 (e & 1), rows of M 16 kk + 2 t +
    // 8 (e >> 1) and the next: folded here, rounded to bf16 again
    auto issue = [&](int u, uint32_t (&av)[4][4]) {
      const uint32_t base = su + L::RING0 + ring.wait_ready(u) * L::STAGE;
      if (!rows) return;
      const int live = a.M - (u0 + u) * MS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = 16 * kk + (lane & 7) + 8 * (j8 >> 1);
        ldmatrix4_trans(av[kk], base + xb * MS * 128 + row * 128 + ((ch ^ (row & 7)) << 4));
        if (pro) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rm = 16 * kk + 2 * t + 8 * (e >> 1);
            const float2 f = bf2(av[kk][e]);
            av[kk][e] = pack_bf16(rm < live ? xhat_of(f.x, fa[e & 1], fb[e & 1], a.relu_in) : 0.f,
                                  rm + 1 < live ? xhat_of(f.y, fa[e & 1], fb[e & 1], a.relu_in) : 0.f);
          }
        }
      }
      reg_fence(acc);
      reg_fence(av);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, av[kk], desc_n<DW_BN, MS>(base + L::XT, 16 * kk, 0), 1);
      wg_commit();
    };
    uint32_t a0[4][4] = {}, a1[4][4] = {};
    for (int u = 0; u < units; u += 2) {
      issue(u, a0);
      if (rows) wg_wait1();
      reg_fence(a1);
      if (u > 0) ring.release(u - 1, lane);
      if (u + 1 < units) {
        issue(u + 1, a1);
        if (rows) wg_wait1();
        reg_fence(a0);
        ring.release(u, lane);
      }
    }
    if (rows) wg_wait();
    reg_fence(acc);
    reg_fence(a0);
    reg_fence(a1);
    if (units > 0) ring.release(units - 1, lane);
  }

  const int kr = k0 + r0 + g;   // this thread's rows of dW: kr, kr + 8
  if (a.splits > 1) {
    const int per_tile = a.splits > SPLIT_GROUP ? (a.splits + SPLIT_GROUP - 1) / SPLIT_GROUP + 1 : 1;
    const bool mine = splitk_sum<32, SPLIT_GROUP>(acc, a.part, (size_t)a.K * a.N, z, a.splits,
                                 a.dw_counts + (kt * gridDim.x + nt) * per_tile, &last,
                                 [&](int i) -> long long {
      const int k = kr + 8 * ((i >> 1) & 1), n = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
      return k < a.K && n < a.N ? (long long)k * a.N + n : -1;
    });
    if (!mine) return;
  }
  T* dw = static_cast<T*>(a.dw);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int k = kr + 8 * ((i >> 1) & 1), n = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (k < a.K && n < a.N) dw[(size_t)k * a.N + n] = from_f32<T>(acc[i]);
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbb_dx_f32_kernel(const __grid_constant__ MbbMaps p) {
  dx_body<true>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbb_dx_bf16_kernel(const __grid_constant__ MbbMaps p) {
  dx_body<false>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbb_dw_f32_kernel(const __grid_constant__ MbbMaps p) {
  dw_body<true>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbb_dw_bf16_kernel(const __grid_constant__ MbbMaps p) {
  dw_body<false>(p);
}

template <bool F32>
int launch(const void* x, const void* w, const void* a, const void* b, const void* y,
           const void* dy, const void* ds1, const void* ds2, void* dx, void* dw, void* da,
           void* db, void* part, void* stats, void* counts, int M, int N, int K, int ldx,
           int ldw, int ldn, int splits, int relu_in, void* stream) {
  using LX = DxSmem<F32>;
  using LW = DwSmem<F32>;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int tiles_m = (M + DX_BM - 1) / DX_BM, tiles_kx = (K + DX_BN - 1) / DX_BN;
  const int groups = (tiles_m + GEMM_GROUP - 1) / GEMM_GROUP;
  MbbArgs q;
  q.x = x;
  q.a = static_cast<const float*>(a);
  q.b = static_cast<const float*>(b);
  q.ds1 = static_cast<const float*>(ds1);
  q.ds2 = static_cast<const float*>(ds2);
  q.dx = dx;
  q.dw = dw;
  q.da = static_cast<float*>(da);
  q.db = static_cast<float*>(db);
  q.part = static_cast<float*>(part);
  q.stats = static_cast<float*>(stats);
  q.counts = static_cast<int*>(counts);
  q.dw_counts = q.counts + 2 * tiles_kx * (groups + 1);
  q.M = M;
  q.N = N;
  q.K = K;
  q.ldx = ldx;
  q.splits = splits;
  q.steps = (M + LW::MS - 1) / LW::MS;
  q.relu_in = relu_in;
  MbbMaps px, pw;
  px.a = pw.a = q;
  if (!(tma_map_sw128(&px.w, w, F32, ldw, K, 1, DX_BN, 1) &&
        tma_map_sw128(&px.dy, dy, F32, ldn, M, 1, DX_BM, 1) &&
        tma_map_sw128(&px.y, y, F32, ldn, M, 1, DX_BM, 1) &&
        vec_map(&px.ds1, ds1, N, LX::CK) && vec_map(&px.ds2, ds2, N, LX::CK) &&
        tma_map_sw128(&pw.x, x, F32, ldx, M, 1, LW::MS, 1) &&
        tma_map_sw128(&pw.dy, dy, F32, ldn, M, 1, LW::MS, 1) &&
        tma_map_sw128(&pw.y, y, F32, ldn, M, 1, LW::MS, 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_kernel(F32 ? mbb_dx_f32_kernel : mbb_dx_bf16_kernel, dim3(tiles_kx, tiles_m),
                               GEMM_THREADS, LX::BYTES, s, px);
  if (rc != 0) return rc;
  return launch_kernel(F32 ? mbb_dw_f32_kernel : mbb_dw_bf16_kernel,
                       dim3((N + DW_BN - 1) / DW_BN, (K + DW_BK - 1) / DW_BK, splits),
                       GEMM_THREADS, LW::BYTES, s, pw);
}

}  // namespace

extern "C" {

// The kernels' tiles, which the wrapper's plan must use: the dx block's
// rows and columns, the dW block's rows and columns, and the rows of M a
// dW stage takes in f32 and in bf16 (i = 0..5).
int matmul_bn_act_bwd_tile(int i) {
  const int sizes[6] = {DX_BM, DX_BN, DW_BK, DW_BN, DwSmem<true>::MS, DwSmem<false>::MS};
  return i >= 0 && i < 6 ? sizes[i] : -1;
}

// x [M, ldx], W [K, ldw], y and dy [M, ldn] (rows zero past K, N), a, b
// [K] or null, ds1, ds2 [N]; dx [M, K], dW [K, N], da, db [K]; the scratch
// of the plan.
int matmul_bn_act_bwd_f32(const void* x, const void* w, const void* a, const void* b,
                          const void* y, const void* dy, const void* ds1, const void* ds2,
                          void* dx, void* dw, void* da, void* db, void* part, void* stats,
                          void* counts, int M, int N, int K, int ldx, int ldw, int ldn,
                          int splits, int relu_in, void* stream) {
  return launch<true>(x, w, a, b, y, dy, ds1, ds2, dx, dw, da, db, part, stats, counts, M, N, K,
                      ldx, ldw, ldn, splits, relu_in, stream);
}

int matmul_bn_act_bwd_bf16(const void* x, const void* w, const void* a, const void* b,
                           const void* y, const void* dy, const void* ds1, const void* ds2,
                           void* dx, void* dw, void* da, void* db, void* part, void* stats,
                           void* counts, int M, int N, int K, int ldx, int ldw, int ldn,
                           int splits, int relu_in, void* stream) {
  return launch<false>(x, w, a, b, y, dy, ds1, ds2, dx, dw, da, db, part, stats, counts, M, N, K,
                       ldx, ldw, ldn, splits, relu_in, stream);
}

}  // extern "C"
