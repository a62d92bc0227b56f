// Flash attention merged backward for Hopper (sm_90a).  For q [BH, Tq, D],
// k, v [BH, Tk, D], the cotangent dout [BH, Tq, D] of the normalized
// output, its log-sum-exp lse [BH, Tq] (NEG_INF on dead rows) and
// delta = rowsum(dout * out) [BH, Tq] (f32), with the visibility rule of
// flash_attention_fwd.cu:
//
//     p  = exp(q.k * scale - lse)         on visible keys of live rows, else 0
//     ds = p * (dout.v - delta) * scale
//     dv = p^T dout    dk = ds^T q    dq = ds k          (all f32)
//
// In bf16, p and ds are rounded to bf16 before their products, as the JAX
// kernel does.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/flash_attention.py
// (flash_attention_block_bwd(merged=True) -> _bwd_merged_kernel), the
// backward of every attention at sequence 1024 and above.
//
// What bounds it on the H100: 10 * Tq * Tk * D operations per head (five
// products of the tile) against (3 Tq + 2 Tk) * D elements read and
// (Tq + 2 Tk) * D written, so at sequence 4096 it is bound by operations,
// on the tensor cores: in f32 three TF32 passes a product (165 TFLOP/s of
// f32-accurate work, flash_attention_sm90.cuh; the CUDA cores' FMA peak is
// 67), in bf16 989 TFLOP/s.
//
// What the design does about it: one pass recomputes the score tile from
// lse, never storing p.  As in the TPU kernel, a block owns a key tile of
// one (batch, head) and walks the query tiles, carrying dk and dv on chip
// (the TPU's VMEM scratch; registers here).  On the TPU the dq partials of
// the key tiles are summed outside the kernel; here every key tile adds
// its ds k of a query tile into dq itself, by the TMA's reduce-add, in
// key-tile order behind one flag per (head, slab, query tile), the adds
// issued by a writer warp while the consumers go on
// (flash_attention.cuh, the ordered sum): dq comes out the same on every
// run, and the only scratch beside dq is the flags, 4 (1 + BH Tq/64) bytes
// a slab.  Query tiles wholly before a causal key tile are skipped, as in
// the JAX kernel.
//
//   * bf16: the key-tile body of flash_attention_sm90.cuh on Hopper's
//     tensor-core path: 128 keys per block, one per consumer warpgroup's
//     wgmma M; q, dout, lse and delta stream in by TMA through a ring
//     while the consumers multiply; s^T and dp^T come out of wgmma in the
//     layout of the A operand that dv += p^T dout and dk += ds^T q take
//     from registers; ds^T goes to shared memory once for dq = ds k.
//   * f32 (bwd_tf32_body below): 64 keys per block, one consumer warpgroup
//     (the f32 tiles, twice split, fill shared memory), every product in
//     three TF32 passes on wgmma.  TF32 wgmma takes both shared operands
//     K-major, so the products are chosen to need no transposed copy of
//     an input: s^T = k q^T and dp^T = v dout^T (A = k, v read into
//     registers; B = q, dout split in place by the producer warpgroup's
//     prep warps); p^T and ds^T go to shared memory (hi | lo) as the B of
//     dv^T += dout^T p and dk^T += q^T ds, whose A operands are dout and q
//     read transposed; dq = ds k with A = ds read transposed from there and
//     B = k^T (hi | lo), which prep transposes once per block.  dk^T and dv^T
//     take each tile's product in a fresh accumulator, added in f32: the
//     tensor core's adds round toward zero, and chained over every query
//     tile that bias grows with Tq.  Below D = 128 k^T and v stay resident and q
//     and dout come in one stage a query tile; from D = 128 on the block owns
//     a 64-column slab and the scores stream through 32-column chunks (q,
//     dout, k, v), then q and dout at the slab.  f32 D = 32 runs D = 64's
//     kernel: the TMA zero-fills the columns past 32 and their score chunk is
//     skipped (a D = 32 template spilled registers).
//
// Head dims past 128 run in column slabs (flash_attention.cuh): of 64
// columns (key_tile_slab in bf16, where D = 128 also takes two; the f32
// blocks' SL).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask, dq and the
// int32 flags [1 + BH * slabs * ceil(Tq/64)] zeroed (slabs: ld / 64 past
// 64).  Every entry point returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for another D, or for tensor maps the CUDA driver
// refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// ------------------------------------------------------------------ f32
// Shared memory of the f32 merged backward's block (one consumer
// warpgroup, KB = 64 keys, 64-row query tiles): k^T (hi | lo) at the
// block's SL output columns (the B of dq = ds k; below D = 128 also the A
// of s^T), v as loaded (below D = 128: the A of dp^T), P: p^T, then ds^T
// (hi | lo) [KB keys, QT queries] (the B of dv^T and dk^T, the A of dq; k as
// loaded before the first tile, for prep to transpose), NDQ dq tiles for
// the writer, and a ring of STAGES slots with their lse log2(e) and
// delta scale (aux).  Below D = 128 a slot holds a query tile's q and dout
// (hi | lo) over all of D.  From D = 128 on (CHUNKED: the block's slab of
// SL = 64 output columns of rows ld long) a score slot holds q and dout
// (hi | lo) and k and v as loaded, all at one CH-column chunk, and the
// product slot q and dout as loaded at the block's columns.  Prep: warps 2-3
// of the producer warpgroup; warp 1 is the dq writer.
template <int D, bool CHUNKED>
struct BwdF32Smem {
  static constexpr int KB = TR, QT = TR, PREP = 64;
  static constexpr int SL = CHUNKED ? 64 : D, CH = CHUNKED ? 32 : D;
  static constexpr int KT = SL * KB * 4, V = CHUNKED ? 0 : KB * D * 4, PT = KB * QT * 4;
  static constexpr int DQT = QT * SL * 4, NDQ = CHUNKED || D > 32 ? 1 : 2;
  static constexpr int TC = QT * CH * 4;                       // a [64, CH] f32 tile
  static constexpr int Q_HI = 0, Q_LO = TC, O_HI = 2 * TC, O_LO = 3 * TC;
  static constexpr int K_IN = 4 * TC, V_IN = 4 * TC + KB * CH * 4;   // CHUNKED score slots
  static constexpr int P_Q = 0, P_O = QT * SL * 4;                    // CHUNKED product slot
  static constexpr int SLOT = CHUNKED ? 4 * TC + 2 * KB * CH * 4 : 4 * TC;
  static constexpr int KT_HI = 0, KT_LO = KT, V_RES = 2 * KT, P_HI = 2 * KT + V,
                       P_LO = P_HI + PT, DQ = P_LO + PT, RING = DQ + NDQ * DQT;
  static constexpr int AUX = 4 * 2 * QT;
  static constexpr int VIS = 4 * (KB + 4);                     // the keys' visibility
  // what is left beside the fixed parts (and 16 bytes of static memory: the ticket)
  static constexpr int FIT =
      (SMEM_MAX - 16 - 1024 - RING - VIS - 8 * (2 + 2 * NDQ)) / (SLOT + AUX + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int AUX0 = RING + STAGES * SLOT, VIS0 = AUX0 + STAGES * AUX, BARS = VIS0 + VIS;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (3 * STAGES + 2 + 2 * NDQ);
};

// A barrier of the consumer warpgroup alone.
__device__ __forceinline__ void consumer_wg_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_THREADS) : "memory");
}

// p^T or ds^T in the accumulators (keys r0 + 8 h, queries 8 j + 2 t + e)
// into P's hi and lo tiles [KB, QT]
__device__ __forceinline__ void to_p(unsigned char* hi, unsigned char* lo, const float (&x)[32],
                                     int r0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = f32_at<TR>(r0 + 8 * h, 8 * j + 2 * t);
      uint32_t xh[2], xl[2];
      split_tf32(x[4 * j + 2 * h], xh[0], xl[0]);
      split_tf32(x[4 * j + 2 * h + 1], xh[1], xl[1]);
      *reinterpret_cast<float2*>(hi + off) = make_float2(__uint_as_float(xh[0]), __uint_as_float(xh[1]));
      *reinterpret_cast<float2*>(lo + off) = make_float2(__uint_as_float(xl[0]), __uint_as_float(xl[1]));
    }
}

// d (64 x N) += A (64 x 64: 8 k-steps) . B (hi | lo at b_hi, b_lo: an R-row
// tile, K-major over the 64), three TF32 passes, and wait for it.  frag(kk,
// hi, lo) gives the A operand of k-step kk.
template <int R, int N, class Frag>
__device__ __forceinline__ void product(float (&d)[N], Frag&& frag, uint32_t b_hi, uint32_t b_lo) {
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) frag(kk, ah[kk], al[kk]);
  reg_fence(d);
  reg_fence(ah);
  reg_fence(al);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma3(d, ah[kk], al[kk], desc_f32<R>(b_hi, 8 * kk), desc_f32<R>(b_lo, 8 * kk));
  wg_commit();
  wg_wait();
  reg_fence(d);
  reg_fence(ah);
  reg_fence(al);
}

// acc (64 x 64 keys) += A . P (hi | lo): the product in a fresh
// accumulator t, then added to acc in f32 (the tensor core's adds round
// toward zero: chained over every query tile into dk and dv, that bias would
// grow with Tq)
template <class Frag>
__device__ __forceinline__ void add_product(float (&acc)[32], float (&t)[32], Frag&& frag,
                                            uint32_t b_hi, uint32_t b_lo) {
  zero(t);
  product<TR>(t, frag, b_hi, b_lo);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += t[i];
}

// The f32 block: KB = 64 keys (kt) of one (batch, head) bh and slab z of SL
// output columns; it walks the 64-row query tiles, skipping those wholly
// before a causal key tile, with dk^T and dv^T in the consumers'
// registers, and adds each query tile's dq = ds k into dq in key-tile order
// (the ordered sum, flash_attention.cuh) through the writer.  Per query
// tile, every product in three TF32 passes (flash_attention_sm90.cuh):
//   s^T = k q^T, dp^T = v dout^T   over 32-column chunks of the head dim;
//                    A = k (from k^T, or CHUNKED the slot's k), v: split in
//                    registers; B = q, dout (hi | lo)
//   p^T, ds^T        in the accumulators (p_ds2), then each to P (hi | lo)
//   dv^T += dout^T p, dk^T += q^T ds     A = dout^T, q^T read transposed
//                    from the slot (CHUNKED: the product slot, split);
//                    B = P
//   dq = ds k        A = ds read transposed from P; B = k^T (hi | lo)
// dq goes to a dq tile in shared memory, which the writer adds into dq.
template <int D, bool CHUNKED>
__device__ __forceinline__ void bwd_tf32_body(const TmaArgs& p, int kt, int bh, int z) {
  using L = BwdF32Smem<D, CHUNKED>;
  constexpr int KB = L::KB, QT = L::QT, SL = L::SL, CH = L::CH, ST = L::STAGES;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  unsigned char* sp = smem_1024(flash_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t full = su + L::BARS, ready = full + 8 * ST, empty = ready + 8 * ST;
  const uint32_t res_full = empty + 8 * ST, res_ready = res_full + 8;
  const uint32_t dq_full = res_ready + 8, dq_free = dq_full + 8 * L::NDQ;
  const BwdArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  // ld: the row length of the head dim; below D = 128 it may be 32 (D = 64's
  // columns past it come in as zeros and their products are skipped)
  const int ld = a.ld, col0 = z * SL, k0 = kt * KB;
  const int chunks = CHUNKED ? ld / CH : 1;   // score slots of a query tile
  auto slot = [&](int s) { return L::RING + s * L::SLOT; };
  auto aux = [&](int s) { return reinterpret_cast<float*>(sp + L::AUX0 + s * L::AUX); };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, L::PREP);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(res_full, 1);
    mbar_init(res_ready, L::PREP);
    for (int b = 0; b < L::NDQ; ++b) {
      mbar_init(dq_full + 8 * b, WG_THREADS);
      mbar_init(dq_free + 8 * b, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_THREADS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - WG_THREADS;
    if (pw == 0) {
      // the TMA loads: k (into P, for prep) and v of the key tile, then
      // every slot in the consumers' order
      mbar_expect_tx(res_full, KB * SL * 4 + L::V);
      tma_f32<SL, KB>(su + L::P_HI, &p.k, res_full, col0, k0, bh);
      if constexpr (!CHUNKED) tma_f32<D, KB>(su + L::V_RES, &p.v, res_full, 0, k0, bh);
      int it = 0;
      for (int qt = 0; qt < a.n_qt; ++qt) {
        const int q0 = qt * QT;
        if (skipped(a, q0, QT, k0)) continue;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          const uint32_t st = su + slot(s), bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * L::TC + (CHUNKED ? 2 * KB * CH * 4 : 0));
          tma_f32<CH, QT>(st + L::Q_HI, &p.q, bar, c * CH, q0, bh);
          tma_f32<CH, QT>(st + L::O_HI, &p.dout, bar, c * CH, q0, bh);
          if constexpr (CHUNKED) {
            tma_f32<CH, KB>(st + L::K_IN, &p.k, bar, c * CH, k0, bh);
            tma_f32<CH, KB>(st + L::V_IN, &p.v, bar, c * CH, k0, bh);
          }
        }
        if constexpr (CHUNKED) {
          const int s = it % ST;
          const uint32_t st = su + slot(s), bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * QT * SL * 4);
          tma_f32<SL, QT>(st + L::P_Q, &p.q, bar, col0, q0, bh);
          tma_f32<SL, QT>(st + L::P_O, &p.dout, bar, col0, q0, bh);
          ++it;
        }
      }
    } else if (pw == 32) {
      // the writer: each query tile's dq tile added into dq in key-tile
      // order (the ordered sum), by TMA reduce-add
      int n = 0;
      for (int qt = 0; qt < a.n_qt; ++qt) {
        if (skipped(a, qt * QT, QT, k0)) continue;
        const int b = n % L::NDQ;
        mbar_wait(dq_full + 8 * b, (n / L::NDQ) & 1);
        int* flag = dq_flag(a, bh, z, qt);
        flag_wait(flag, kt);
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
        for (int x = 0; x < SL / 32; ++x)
          if (col0 + 32 * x < ld)
            tma_add_box(&p.dq, su + L::DQ + b * L::DQT + x * QT * 128, col0 + 32 * x, qt * QT, bh);
        tma_adds_commit();
        tma_adds_done();
        st_release(flag, kt + 1);
        mbar_arrive(dq_free + 8 * b);
        ++n;
      }
    } else if (pw >= 64) {
      // prep: k^T (hi | lo) from k, then each slot's q and dout split in
      // place (score slots) and the query tile's lse log2(e), delta scale
      const int pt = pw - 64;
      mbar_wait(res_full, 0);
      transpose_split<KB, SL, false>(sp + L::P_HI, sp + L::KT_HI, sp + L::KT_LO, pt, L::PREP);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(res_ready);
      int it = 0;
      for (int qt = 0; qt < a.n_qt; ++qt) {
        const int q0 = qt * QT;
        if (skipped(a, q0, QT, k0)) continue;
        const float2 row = row_terms(a, bh, q0 + pt);
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          unsigned char* st = sp + slot(s);
          mbar_wait(full + 8 * s, (it / ST) & 1);
          split_in_place(st + L::Q_HI, st + L::Q_LO, L::TC, pt, L::PREP);
          split_in_place(st + L::O_HI, st + L::O_LO, L::TC, pt, L::PREP);
          aux(s)[pt] = row.x;
          aux(s)[QT + pt] = row.y;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ready + 8 * s);
        }
        if constexpr (CHUNKED) {
          // the product slot is used as loaded
          const int s = it % ST;
          mbar_wait(full + 8 * s, (it / ST) & 1);
          mbar_arrive(ready + 8 * s);
          ++it;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wq = tid / 32, g = lane >> 2, t = lane & 3;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;
  const int r0 = 16 * wq + g;                  // this thread's first row of an M = 64 tile
  // The visibility of key k0 + r of the block to query column c of the tile
  // at q0: seen where c >= min(QT, seen_from[r] - q0) (causal; non-causal
  // seen_from[r] - 0), seen_from huge for a key past Tk or masked; and every
  // entry of warp w's 16 keys is seen (no per-entry rule) where q0 >=
  // exact_from[w].  Kept in shared memory: read once a tile, they would
  // otherwise hold registers the products need.
  int* seen_from = reinterpret_cast<int*>(sp + L::VIS0);
  int* exact_from = seen_from + KB;
  bool all_ok = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + r0 + 8 * h;
    const bool ok = kg < a.tk && (km == nullptr || km[kg] > 0.f);
    if (t == 0) seen_from[r0 + 8 * h] = ok ? (a.causal ? kg + a.k_offset - a.q_offset : 0) : 1 << 30;
    all_ok = all_ok && ok;
  }
  all_ok = __all_sync(0xffffffffu, all_ok);
  if (lane == 0)
    exact_from[wq] = !all_ok ? 1 << 30
                     : a.causal ? k0 + 16 * wq + 15 + a.k_offset - a.q_offset : -(1 << 30);
  __syncwarp();
  const float sl2 = a.scale * LOG2E;
  float dk[32], dv[32];   // dk^T, dv^T: columns col0 + r0 + 8 h, keys 8 j + 2 t + e
  zero(dk);
  zero(dv);
  mbar_wait(res_ready, 0);
  int it = 0, n = 0;      // n: dq tiles handed to the writer
  for (int qt = 0; qt < a.n_qt; ++qt) {
    const int q0 = qt * QT;
    if (skipped(a, q0, QT, k0)) continue;
    // s^T = k q^T and dp^T = v dout^T: keys k0 + r0 + 8 h, queries 8 j + 2 t + e
    // (k and v by plain shared loads: ldmatrix, as the forward reads q, made
    // ptxas spill here)
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    int s = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      s = it % ST;
      const int sl = slot(s);
      mbar_wait(ready + 8 * s, (it / ST) & 1);
#pragma unroll
      for (int c2 = 0; c2 < CH && c2 < ld; c2 += 32) {
        uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (CHUNKED)
            a_split<KB, false>(kh[kk], kl[kk], sp + sl + L::K_IN, r0, c2 + 8 * kk + t);
          else
            a_pair<SL, true>(kh[kk], kl[kk], sp + L::KT_HI, L::KT, r0, c2 + 8 * kk + t);
        }
        reg_fence(st);
        reg_fence(dpt);
        reg_fence(kh);
        reg_fence(kl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(st, kh[kk], kl[kk], desc_f32<QT>(su + sl + L::Q_HI, c2 + 8 * kk),
               desc_f32<QT>(su + sl + L::Q_LO, c2 + 8 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          a_split<KB, false>(vh[kk], vl[kk], sp + (CHUNKED ? sl + L::V_IN : L::V_RES), r0,
                             c2 + 8 * kk + t);
        reg_fence(vh);
        reg_fence(vl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(dpt, vh[kk], vl[kk], desc_f32<QT>(su + sl + L::O_HI, c2 + 8 * kk),
               desc_f32<QT>(su + sl + L::O_LO, c2 + 8 * kk));
        wg_commit();
        wg_wait();
        reg_fence(st);
        reg_fence(dpt);
        reg_fence(kh);
        reg_fence(kl);
        reg_fence(vh);
        reg_fence(vl);
      }
      // the last score slot stays until p and ds are made from its aux (and,
      // below D = 128, until its q and dout have served dv^T and dk^T)
      if (c + 1 < chunks) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // p^T and ds^T in place (entry 4 j + e: key h = e >> 1, query column
    // 8 j + 2 t + (e & 1))
    const float* rows = aux(s);
    int from[2];                    // entry 4 j + e is seen where 8 j + (e & 1) >= from[h]
    const bool exact = q0 >= exact_from[wq];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      from[h] = exact ? -QT : min(QT, seen_from[r0 + 8 * h] - (a.causal ? q0 : 0)) - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const float2 pd = p_ds2(st[4 * j + e], dpt[4 * j + e], make_float2(rows[ql], rows[QT + ql]),
                                sl2, a.scale, 8 * j + (e & 1) >= from[h]);
        st[4 * j + e] = pd.x;
        dpt[4 * j + e] = pd.y;
      }
    // the product operands: this query tile's dout and q, (hi | lo) in the
    // score slot below D = 128, as loaded in the product slot from D = 128 on
    int ps = s;
    if constexpr (CHUNKED) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ps = it % ST;
      mbar_wait(ready + 8 * ps, (it / ST) & 1);
      ++it;
    }
    const unsigned char* pq = sp + slot(ps) + (CHUNKED ? L::P_Q : L::Q_HI);
    const unsigned char* po = sp + slot(ps) + (CHUNKED ? L::P_O : L::O_HI);
    // A = x^T over the query tile (x: q or dout; rows r0 + 8 h of its SL
    // columns), read transposed from the slot
    auto xt = [&](const unsigned char* x) {
      return [=](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        if constexpr (CHUNKED)
          a_split<QT, true>(hi, lo, x, r0, 8 * kk + t);
        else
          a_pair<QT, true>(hi, lo, x, L::TC, r0, 8 * kk + t);
      };
    };
    float tile[32];                // a product's fresh accumulator (add_product)

    // dv^T += dout^T p: B = p^T from P, once the last tile's readers of P
    // are done
    consumer_wg_sync();
    to_p(sp + L::P_HI, sp + L::P_LO, st, r0, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_wg_sync();
    add_product(dv, tile, xt(po), su + L::P_HI, su + L::P_LO);

    // dk^T += q^T ds: the same with q and ds^T
    to_p(sp + L::P_HI, sp + L::P_LO, dpt, r0, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_wg_sync();
    add_product(dk, tile, xt(pq), su + L::P_HI, su + L::P_LO);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ps);   // the slot's q and dout are read

    // dq = ds k: A (queries r0 + 8 h, keys) read transposed from P; B = k^T
    float dq[SL / 2];     // queries r0 + 8 h, columns col0 + 8 j + 2 t + e
    zero(dq);
    product<SL>(dq, [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      a_pair<KB, true>(hi, lo, sp + L::P_HI, L::PT, r0, 8 * kk + t);
    }, su + L::KT_HI, su + L::KT_LO);

    // to the writer, in the dq tile's swizzled boxes of 32 columns
    const int b = n % L::NDQ;
    mbar_wait(dq_free + 8 * b, ((n / L::NDQ) & 1) ^ 1);
    unsigned char* dq_tile = sp + L::DQ + b * L::DQT;
#pragma unroll
    for (int j = 0; j < SL / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dq_tile + f32_at<QT>(r0 + 8 * h, 8 * j + 2 * t)) =
            make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(dq_full + 8 * b);
    ++n;
  }

  // dk, dv: key kg, column col0 + d from dk^T, dv^T
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = r0 + 8 * h;
    if (d >= SL || col0 + d >= ld) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key >= a.tk) continue;
        const size_t i = ((size_t)bh * a.tk + key) * ld + col0 + d;
        a.dk[i] = dk[4 * j + 2 * h + e];
        a.dv[i] = dv[4 * j + 2 * h + e];
      }
  }
}

// The block's tile comes from the ticket flags[0] (the ordered sum).
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
fa_bwd_f32_kernel(const __grid_constant__ TmaArgs p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.a.flags, 1);
  __syncthreads();
  const KeyTileIdx i = key_tile_of(p.a, ticket);
  bwd_tf32_body<D, CHUNKED>(p, i.kt, i.bh, i.z);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_bwd_bf16_kernel(const __grid_constant__ TmaArgs p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.a.flags, 1);
  __syncthreads();
  const KeyTileIdx i = key_tile_of(p.a, ticket);
  key_tile_body<D, true, WIDE>(p, i.kt, i.bh, i.z);
}

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& args, cudaStream_t s) {
  BwdArgs a = args;
  TmaArgs p;
  if constexpr (BF16) {
    a.slabs = a.ld / key_tile_slab<D, WIDE>();
    const int rc = tma_args(p, a, true);
    if (rc != 0) return rc;
    const dim3 grid(((a.tk + KeyTileSmem<D, true, WIDE>::KB - 1) /
                     KeyTileSmem<D, true, WIDE>::KB) * a.bh * a.slabs);
    return launch_kernel(fa_bwd_bf16_kernel<D, WIDE>, grid, SM90_THREADS,
                         KeyTileSmem<D, true, WIDE>::BYTES, s, p);
  } else {
    // D = 128, and past it in slabs of 64 columns: one template
    constexpr bool CHUNKED = D == 128;
    using L = BwdF32Smem<D, CHUNKED>;
    a.slabs = a.ld > L::SL ? a.ld / L::SL : 1;
    p.a = a;
    if (!(encode_f32_map(&p.q, a.q, a.bh, a.tq, a.ld) && encode_f32_map(&p.k, a.k, a.bh, a.tk, a.ld) &&
          encode_f32_map(&p.v, a.v, a.bh, a.tk, a.ld) &&
          encode_f32_map(&p.dout, a.dout, a.bh, a.tq, a.ld) &&
          encode_f32_map(&p.dq, a.dq, a.bh, a.tq, a.ld)))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(((a.tk + L::KB - 1) / L::KB) * a.bh * a.slabs);
    return launch_kernel(fa_bwd_f32_kernel<D, CHUNKED>, grid, 2 * WG_THREADS, L::BYTES, s, p);
  }
}

template <bool BF16>
int dispatch(int d, const BwdArgs& a, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<BF16 ? 32 : 64, BF16>(a, s);   // f32: D = 64's kernel
    case 64: return launch<64, BF16>(a, s);
    case 128: return launch<128, BF16>(a, s);
  }
  // past 128 in column slabs: of 64 in bf16 (key_tile_slab) and f32
  if (wide_head_dim(d)) return launch<BF16 ? 64 : 128, BF16, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, void* flags, int bh, int heads, int tq, int tk,
                            int q_offset, int k_offset, int causal, int d, float scale,
                            void* stream) {
  return dispatch<false>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, flags, bh,
                                     heads, tq, tk, q_offset, k_offset, causal, d, scale),
                         stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             const void* dout, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, void* flags, int bh, int heads, int tq, int tk,
                             int q_offset, int k_offset, int causal, int d, float scale,
                             void* stream) {
  return dispatch<true>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, flags, bh,
                                    heads, tq, tk, q_offset, k_offset, causal, d, scale),
                        stream);
}

}  // extern "C"
