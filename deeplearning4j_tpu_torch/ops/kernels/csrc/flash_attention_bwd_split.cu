// Flash attention two-kernel backward for Hopper (sm_90a).  The same
// function as flash_attention_bwd.cu (the merged form), for q [BH, Tq, D],
// k, v [BH, Tk, D], dout [BH, Tq, D], lse and delta [BH, Tq]:
//
//     p  = exp(q.k * scale - lse)         on visible keys of live rows, else 0
//     ds = p * (dout.v - delta) * scale
//     dq = ds k    dv = p^T dout    dk = ds^T q          (all f32)
//
// in two kernels that write no partials.
//
// Replaces the TPU kernels deeplearning4j_tpu/ops/pallas/flash_attention.py
// (flash_attention_block_bwd(merged=False)): _bwd_dq_kernel and
// _bwd_dkv_kernel.
//
//   * dq kernel (fa_dq_*): a block owns a tile of query rows of one
//     (batch, head), walks the key tiles, recomputes p and ds, and
//     accumulates dq = ds k in registers in f32 (the TPU kernel's dq_scr),
//     written once.  Key tiles wholly in a causal query tile's future are
//     never visited.  In bf16 ds is rounded to bf16 before ds k and p is
//     not, as the JAX kernel does.
//   * dk/dv kernel (fa_dkv_*): a block owns a key tile and walks the query
//     tiles: the merged kernel's body with its dq products compiled out,
//     skipping the query tiles wholly before a causal key tile.  In bf16 p
//     and ds are rounded before their products.
//
// What bounds it on the H100: the function needs 10 * Tq * Tk * D
// operations per head (five products, as the merged form) against
// (4 Tq + 4 Tk) * D elements read and (Tq + 2 Tk) * D written, so at
// sequence 4096 it is bound by operations, on the tensor cores: in f32
// three TF32 passes a product (165 TFLOP/s of f32-accurate work,
// flash_attention_sm90.cuh; the CUDA cores' FMA peak is 67), in bf16 989
// TFLOP/s.  This algorithm does 14 (s and dp are computed in both
// kernels): two more products per tile than the merged form, and no
// scratch at all.
//
// What the design does about it: both dtypes run on Hopper's tensor-core
// path (flash_attention_sm90.cuh), wgmma fed by TMA, with a producer warp
// streaming the other side's tiles through a ring of stages behind
// mbarriers.  The dk/dv kernel is the merged form's key-tile body without
// dq (bf16: key_tile_body; f32: bwd_tf32_body).
//   * bf16 dq kernel: the block holds 128 query rows, 64 per consumer
//     warpgroup as the M of its wgmma, with q and dout loaded once by TMA
//     and 64-key k and v tiles streamed; s = q k^T and dp = dout v^T run as
//     wgmma from shared memory, and ds, rounded in the accumulator
//     registers, is the register A operand of dq += ds k.
//   * f32 dq kernel (fa_dq_f32_kernel below): one consumer warpgroup owns
//     64 query rows (f32 tiles, twice split, fill shared memory), every
//     product in three TF32 passes.  TF32 wgmma takes both shared operands
//     K-major, so q and dout are the register A operands (read by ldmatrix
//     and split), k and v the B (split in place by the producer
//     warpgroup's prep warps), and dq = ds k takes ds from the accumulator
//     as its A and k^T as its B, which prep transposes from each k tile
//     (keys permuted within each 8 to match where the accumulator leaves
//     ds).  Each tile's ds k lands in a fresh accumulator and is added to
//     dq in f32: the tensor core's adds round toward zero.  Below D = 128 q
//     and dout stay resident; from D = 128 on the block owns a 128-column
//     slab of dq and the scores stream through 64-column chunks of q, dout,
//     k and v, then k at the slab.  The f32 dk/dv kernel at D = 32 is D =
//     64's: the TMA zero-fills the columns past 32 and their score products
//     are skipped (a D = 32 key-tile template spilled registers).
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// column slabs (flash_attention.cuh): of 128 columns in the dq kernels and
// of 64 in the dk/dv kernels.

// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launches (cudaErrorInvalidValue
// for another D, or for tensor maps the CUDA driver refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// ------------------------------------------------------------- f32 dq kernel
// Shared memory of the f32 dq kernel (one consumer warpgroup, QT = 64 query
// rows, tiles of KN = 64 keys).  Below D = 128 the block's q and dout rows
// as loaded (resident), and one slot a key tile: k and v (hi | lo) [KN, D]
// (the B of s = q k^T and dp = dout v^T) and k^T (hi | lo) [D, KN] with its
// keys permuted within each 8 (key_column: the B of dq = ds k, whose A is ds
// where the accumulator left it).  From D = 128 on (CHUNKED: the block's
// slab of SL = 128 dq columns of rows ld long) a score slot holds q and
// dout as loaded and k and v (hi | lo), all at one CH = 64-column chunk,
// and the product slot k as loaded at the block's columns and its k^T
// (hi | lo).  Each slot has its keys' visibility (aux) and full, ready and
// empty barriers.
template <int D, bool CHUNKED>
struct DqF32Smem {
  static constexpr int QT = TR, KN = TR, PREP = 96;
  static constexpr int SL = CHUNKED ? 128 : D, CH = CHUNKED ? 64 : D;
  static constexpr int RES = CHUNKED ? 0 : 2 * QT * D * 4;
  static constexpr int TK = KN * CH * 4;                         // a [KN, CH] f32 tile
  static constexpr int S_Q = 0, S_O = CHUNKED ? QT * CH * 4 : 0, S_K_HI = 2 * S_O,
                       S_K_LO = S_K_HI + TK, S_V_HI = S_K_LO + TK, S_V_LO = S_V_HI + TK;
  static constexpr int SCORE = S_V_LO + TK;                      // a score slot's bytes
  static constexpr int KT = SL * KN * 4;                         // k^T (hi or lo)
  static constexpr int P_K = 0, P_KT_HI = CHUNKED ? KN * SL * 4 : SCORE, P_KT_LO = P_KT_HI + KT;
  static constexpr int PRODUCT = P_KT_LO + KT;
  static constexpr int SLOT = SCORE > PRODUCT ? SCORE : PRODUCT;
  static constexpr int AUX = 4 * (KN + 2);                       // 8-byte aligned
  static constexpr int FIT = (SMEM_MAX - 1024 - RES) / (SLOT + AUX + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING = RES, AUX0 = RING + STAGES * SLOT, BARS = AUX0 + STAGES * AUX;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (3 * STAGES + 1);
};

// One block owns QT = 64 query rows (blockIdx.x) of one (batch, head)
// (blockIdx.y) and slab blockIdx.z of dq (CHUNKED), and walks the tiles of
// KN = 64 keys up to the last one its rows see, with dq in the consumers'
// registers, written once.  Per key tile, in three TF32 passes
// (flash_attention_sm90.cuh):
//   s = q k^T, dp = dout v^T   A = q, dout, read from the resident rows
//                  (CHUNKED: from the score slots) 32 columns at a time by
//                  ldmatrix and split in registers; B = k, v (hi | lo)
//   ds (p_ds2)     in the accumulator registers
//   dq += ds k     A = ds, split where the accumulator left it (lane t holds
//                  keys 2 t and 2 t + 1 of each 8, the A operand's columns t
//                  and t + 4); B = k^T (hi | lo), keys permuted to match;
//                  the tile's product in a fresh accumulator, added to dq in
//                  f32 (the tensor core's adds round toward zero: chained
//                  over every key tile, that bias would grow with Tk)
// The producer warpgroup: one thread issues each slot's TMA loads, warps 1-3
// (prep) split k and v in place, transpose k into k^T and write the keys'
// visibility, then mark the slot ready; the consumers release it.
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
fa_dq_f32_kernel(const __grid_constant__ TmaArgs p) {
  using L = DqF32Smem<D, CHUNKED>;
  constexpr int QT = L::QT, KN = L::KN, SL = L::SL, CH = L::CH, ST = L::STAGES;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  unsigned char* sp = smem_1024(flash_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t full = su + L::BARS, ready = full + 8 * ST, empty = ready + 8 * ST,
                 res_bar = empty + 8 * ST;
  const BwdArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * QT;
  // ld: the row length of the head dim; below D = 128 it may be 32 (D = 64's
  // columns past it come in as zeros and their score products are skipped)
  const int ld = a.ld, col0 = CHUNKED ? blockIdx.z * SL : 0;
  const int chunks = CHUNKED ? ld / CH : 0;   // score slots of a key tile
  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + QT, a.tq) - 1, KN);
  auto slot = [&](int s) { return L::RING + s * L::SLOT; };
  auto aux = [&](int s) { return reinterpret_cast<float*>(sp + L::AUX0 + s * L::AUX); };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, L::PREP);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_THREADS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - WG_THREADS;
    if (pw == 0) {
      // the block's q and dout rows, then every slot in the consumers' order
      if constexpr (!CHUNKED) {
        mbar_expect_tx(res_bar, L::RES);
        tma_f32<D, QT>(su, &p.q, res_bar, 0, q0, bh);
        tma_f32<D, QT>(su + QT * D * 4, &p.dout, res_bar, 0, q0, bh);
      }
      int it = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * KN;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          const uint32_t st = su + slot(s), bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * QT * CH * 4 + 2 * L::TK);
          tma_f32<CH, QT>(st + L::S_Q, &p.q, bar, c * CH, q0, bh);
          tma_f32<CH, QT>(st + L::S_O, &p.dout, bar, c * CH, q0, bh);
          tma_f32<CH, KN>(st + L::S_K_HI, &p.k, bar, c * CH, k0, bh);
          tma_f32<CH, KN>(st + L::S_V_HI, &p.v, bar, c * CH, k0, bh);
        }
        const int s = it % ST;
        const uint32_t st = su + slot(s), bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
        if constexpr (CHUNKED) {
          mbar_expect_tx(bar, KN * SL * 4);
          tma_f32<SL, KN>(st + L::P_K, &p.k, bar, col0, k0, bh);
        } else {
          mbar_expect_tx(bar, 2 * L::TK);
          tma_f32<D, KN>(st + L::S_K_HI, &p.k, bar, 0, k0, bh);
          tma_f32<D, KN>(st + L::S_V_HI, &p.v, bar, 0, k0, bh);
        }
        ++it;
      }
    } else if (pw >= 32) {
      // prep
      const int pt = pw - 32;
      const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;
      int it = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * KN;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          unsigned char* st = sp + slot(s);
          mbar_wait(full + 8 * s, (it / ST) & 1);
          split_in_place(st + L::S_K_HI, st + L::S_K_LO, L::TK, pt, L::PREP);
          split_in_place(st + L::S_V_HI, st + L::S_V_LO, L::TK, pt, L::PREP);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ready + 8 * s);
        }
        const int s = it % ST;
        unsigned char* st = sp + slot(s);
        mbar_wait(full + 8 * s, (it / ST) & 1);
        if constexpr (CHUNKED) {
          transpose_split<KN, SL, true>(st + L::P_K, st + L::P_KT_HI, st + L::P_KT_LO, pt, L::PREP);
        } else {
          split_transpose<KN, D>(st + L::S_K_HI, st + L::S_K_LO, st + L::P_KT_HI,
                                 st + L::P_KT_LO, pt, L::PREP);
          split_in_place(st + L::S_V_HI, st + L::S_V_LO, L::TK, pt, L::PREP);
        }
        if (pt < 32) {
          // the tile's keys: below Tk and unmasked (1) or not (0); aux[KN]: all are
          float* x = aux(s);
          bool all = true;
#pragma unroll
          for (int h = 0; h < KN / 32; ++h) {
            const int kg = k0 + pt + 32 * h;
            const bool vis = kg < a.tk && (km == nullptr || km[kg] > 0.f);
            x[pt + 32 * h] = vis ? 1.f : 0.f;
            all = all && vis;
          }
          all = __all_sync(0xffffffffu, all);
          if (pt == 0) x[KN] = all ? 1.f : 0.f;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready + 8 * s);
        ++it;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wq = tid / 32, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * wq;                      // this warp's first row of the tile
  int qg[2];
  float2 rows[2];                              // row_terms of rows qg[h]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qg[h] = q0 + m0 + g + 8 * h;
    rows[h] = row_terms(a, bh, qg[h]);
  }
  const float sl2 = a.scale * LOG2E;
  float dq[SL / 2];                            // rows qg[h], columns col0 + 8 j + 2 t + e
  zero(dq);
  if constexpr (!CHUNKED) mbar_wait(res_bar, 0);
  // s += q k^T and dp += dout v^T over the CH columns of slot st (A: q and
  // dout from qa and oa, 32 columns at a time; B: the slot's k and v)
  auto scores = [&](float (&sc)[32], float (&dp)[32], uint32_t st, uint32_t qa, uint32_t oa) {
#pragma unroll
    for (int c2 = 0; c2 < CH && c2 < ld; c2 += 32) {
      uint32_t qh[4][4], ql[4][4], oh[4][4], ol[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_split_rows<QT>(qh[kk], ql[kk], qa, m0, c2 + 8 * kk, lane);
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(qh);
      reg_fence(ql);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma3(sc, qh[kk], ql[kk], desc_f32<KN>(st + L::S_K_HI, c2 + 8 * kk),
             desc_f32<KN>(st + L::S_K_LO, c2 + 8 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_split_rows<QT>(oh[kk], ol[kk], oa, m0, c2 + 8 * kk, lane);
      reg_fence(oh);
      reg_fence(ol);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma3(dp, oh[kk], ol[kk], desc_f32<KN>(st + L::S_V_HI, c2 + 8 * kk),
             desc_f32<KN>(st + L::S_V_LO, c2 + 8 * kk));
      wg_commit();
      wg_wait();
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(qh);
      reg_fence(ql);
      reg_fence(oh);
      reg_fence(ol);
    }
  };
  int it = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    // s = q k^T and dp = dout v^T: rows qg[h], keys 8 j + 2 t + e
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    for (int c = 0; c < chunks; ++c, ++it) {   // CHUNKED: the score slots
      const int s = it % ST;
      const uint32_t st = su + slot(s);
      mbar_wait(ready + 8 * s, (it / ST) & 1);
      scores(sc, dp, st, st + L::S_Q, st + L::S_O);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // the product slot (below D = 128 also the score slot)
    const int s = it % ST;
    mbar_wait(ready + 8 * s, (it / ST) & 1);
    ++it;
    if constexpr (!CHUNKED) scores(sc, dp, su + slot(s), su, su + QT * D * 4);
    // ds in place of s (entry 4 j + e: row qg[e >> 1], key 8 j + 2 t + (e & 1))
    const float* vis = aux(s);
    const bool exact =
        vis[KN] > 0.f && (!a.causal || a.q_offset + q0 + m0 >= a.k_offset + k0 + KN - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool seen = exact || (vis[kl] > 0.f && causal_ok(a, qg[h], k0 + kl));
        sc[4 * j + e] = p_ds2(sc[4 * j + e], dp[4 * j + e], rows[h], sl2, a.scale, seen).y;
      }
    // ds as the A operand of each 8-key step j: keys 2 t, 2 t + 1 of rows
    // qg[0], qg[1] (entries 4 j + e) at its columns t, t + 4
    uint32_t dh[8][4], dl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(sc[4 * j], dh[j][0], dl[j][0]);
      split_tf32(sc[4 * j + 2], dh[j][1], dl[j][1]);
      split_tf32(sc[4 * j + 1], dh[j][2], dl[j][2]);
      split_tf32(sc[4 * j + 3], dh[j][3], dl[j][3]);
    }
    // up to 64 columns of dq a product (k^T's rows c0..)
    const uint32_t kt_hi = su + slot(s) + L::P_KT_HI, kt_lo = su + slot(s) + L::P_KT_LO;
    constexpr int NP = SL < 64 ? SL : 64;
#pragma unroll
    for (int c0 = 0; c0 < SL; c0 += NP) {
      float tile[NP / 2];
      zero(tile);
      reg_fence(tile);
      reg_fence(dh);
      reg_fence(dl);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma3(tile, dh[j], dl[j], desc_f32<SL>(kt_hi + c0 * 128, 8 * j),
             desc_f32<SL>(kt_lo + c0 * 128, 8 * j));
      wg_commit();
      wg_wait();
      reg_fence(tile);
      reg_fence(dh);
      reg_fence(dl);
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) dq[c0 / 2 + i] += tile[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qg[h] >= a.tq) continue;
    const size_t row = ((size_t)bh * a.tq + qg[h]) * ld;
#pragma unroll
    for (int j = 0; j < SL / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col < ld)
        *reinterpret_cast<float2*>(a.dq + row + col) =
            make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------- dk/dv kernels
// The merged backward's f32 key-tile body without dq (flash_attention_sm90.cuh)
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
fa_dkv_f32_kernel(const __grid_constant__ TmaArgs p) {
  bwd_tf32_body<D, CHUNKED, false>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_dkv_bf16_kernel(const __grid_constant__ TmaArgs p) {
  key_tile_body<D, false, WIDE>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& a, cudaStream_t s) {
  TmaArgs p;
  int rc;
  if constexpr (BF16) {
    // past 128 the dk/dv kernel runs the merged body's 64-column slabs
    constexpr int DKV = WIDE ? 64 : D;
    using QL = QTileSmem<D, WIDE, 2>;
    using KL = KeyTileSmem<DKV, false, WIDE>;
    rc = tma_args(p, a, false);
    const dim3 q_grid((a.tq + QL::QB - 1) / QL::QB, a.bh, WIDE ? a.ld / D : 1),
        k_grid((a.tk + KL::KB - 1) / KL::KB, a.bh, a.ld / key_tile_slab<DKV, WIDE>());
    if (rc == 0)
      rc = launch_kernel(fa_dq_bf16_kernel<D, WIDE>, q_grid, SM90_THREADS, QL::BYTES, s, p);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_bf16_kernel<DKV, WIDE>, k_grid, SM90_THREADS, KL::BYTES, s, p);
  } else {
    // D = 128, and past it in slabs (of 128 columns in the dq kernel, 64 in
    // the dk/dv kernel): one template each; D = 32 runs the dk/dv kernel of
    // D = 64 (the TMA zero-fills the columns past 32)
    constexpr bool CHUNKED = D == 128;
    using QL = DqF32Smem<D, CHUNKED>;
    using KL = BwdF32Smem<D == 32 ? 64 : D, CHUNKED, false>;
    p.a = a;
    const bool ok = encode_f32_map(&p.q, a.q, a.bh, a.tq, a.ld) &&
                    encode_f32_map(&p.k, a.k, a.bh, a.tk, a.ld) &&
                    encode_f32_map(&p.v, a.v, a.bh, a.tk, a.ld) &&
                    encode_f32_map(&p.dout, a.dout, a.bh, a.tq, a.ld);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 q_grid((a.tq + QL::QT - 1) / QL::QT, a.bh, a.ld > QL::SL ? a.ld / QL::SL : 1),
        k_grid((a.tk + KL::KB - 1) / KL::KB, a.bh, a.ld > KL::SL ? a.ld / KL::SL : 1);
    rc = launch_kernel(fa_dq_f32_kernel<D, CHUNKED>, q_grid, 2 * WG_THREADS, QL::BYTES, s, p);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_f32_kernel<D == 32 ? 64 : D, CHUNKED>, k_grid, 2 * WG_THREADS,
                         KL::BYTES, s, p);
  }
  return rc;
}

template <bool BF16>
int dispatch(int d, const BwdArgs& a, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32, BF16>(a, s);
    case 64: return launch<64, BF16>(a, s);
    case 128: return launch<128, BF16>(a, s);
  }
  // past 128 in column slabs: of 128 in the dq kernels, of 64 in the dk/dv kernels
  if (wide_head_dim(d)) return launch<128, BF16, BF16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_bwd_split_f32(const void* q, const void* k, const void* v,
                                  const void* kmask, const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk, void* dv, int bh,
                                  int heads, int tq, int tk, int q_offset, int k_offset,
                                  int causal, int d, float scale, void* stream) {
  return dispatch<false>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, nullptr, bh,
                                     heads, tq, tk, q_offset, k_offset, causal, d, scale),
                         stream);
}

int flash_attention_bwd_split_bf16(const void* q, const void* k, const void* v,
                                   const void* kmask, const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk, void* dv, int bh,
                                   int heads, int tq, int tk, int q_offset, int k_offset,
                                   int causal, int d, float scale, void* stream) {
  return dispatch<true>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, nullptr, bh,
                                    heads, tq, tk, q_offset, k_offset, causal, d, scale),
                        stream);
}

}  // extern "C"
