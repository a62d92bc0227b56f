// Flash attention forward for Hopper (sm_90a).  For q [BH, Tq, D] and
// k, v [BH, Tk, D] (contiguous, heads flattened into BH = B*H), with
// s = q.k * scale over the visible keys of each row:
//
//     o[BH,Tq,D] = sum_k exp(s - m) v      m[BH,Tq] = max_k s
//     l[BH,Tq]   = sum_k exp(s - m)        (all f32; unnormalized)
//
// or, when normalize is set, out = o / max(l, 1e-20) in the inputs' dtype
// and lse = m + log(l) (NEG_INF where l == 0).  A key is visible to a row
// when its index is below Tk, its entry of the [B, Tk] key mask (if any)
// is above 0, and, under causal, q_offset + row >= k_offset + key.  A row
// that sees no key ends with o = 0, m = NEG_INF, l = 0.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/flash_attention.py
// (flash_attention_block -> _kernel), the inner step of every attention
// at sequence 1024 and above (BERT at sequence 4096).
//
// What bounds it on the H100: 4 * Tq * Tk * D operations per head
// against (Tq + 2 Tk) * D elements read, so at sequence 4096 it is bound
// by operations: in f32 by the CUDA cores (67 TFLOP/s; the JAX kernel asks
// for Precision.HIGHEST, so no TF32), in bf16 by the tensor cores.
//
// What the design does about it: the [Tq, Tk] scores never leave the SM.
// The TPU kernel walks the K blocks as a sequential grid axis and carries
// (acc, m, l) in VMEM scratch; here one thread block owns a tile of queries
// of one (batch, head) and loops over the key tiles itself (of 64 keys; of
// 128 in bf16 below D = 128), with the running (m, l) and the accumulator in
// registers.  K tiles wholly in a causal row tile's future are never loaded
// (the loop ends before them).
//   * f32: 64 query rows a block, 256 threads, each owning 4 rows x 4
//     columns (rows ty + 16 i, columns tx + 16 j, conflict-free on the
//     odd-length padded rows) of the score tile and 4 x D/16 of the output,
//     FMA in f32 on the CUDA cores.  The row max and sum are reduced over
//     the 16 lanes that share a row; p goes through shared memory to the
//     p.v product.
//   * bf16: Hopper's tensor-core path, on flash_attention_sm90.cuh's query-
//     tile blocks: 128 query rows a block, one producer warpgroup and two
//     consumer warpgroups of 64 rows each.  The producer brings q in once by
//     TMA and streams k and v of every key tile through a ring of stages
//     behind mbarriers, with the tile's key visibility; the consumers run
//     s = q k^T as wgmma from swizzled shared memory, the online softmax in
//     the accumulator registers (exp2 with scale log2(e) folded in, the
//     per-entry visibility rule only on tiles the Tk tail, the key mask or
//     the causal rule cut), and o += p v as wgmma with p, rounded to bf16
//     (as the JAX kernel does), as the register A operand.  The two
//     warpgroups run apart, so one's softmax overlaps the other's products.
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// 128-column slabs (flash_attention.cuh; in bf16 the scores then sum over
// 64-column chunks of q and k streamed through the ring).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for another D, or for tensor maps cuTensorMapEncodeTiled refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

constexpr int BQ = 64;       // query rows per f32 block

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [B, Tk] or null
  float* o;             // [BH, Tq, D]  (normalize == 0)
  float* m;             // [BH, Tq]     (normalize == 0)
  float* l;             // [BH, Tq]     (normalize == 0)
  void* out;            // [BH, Tq, D] in the inputs' dtype (normalize == 1)
  float* lse;           // [BH, Tq]     (normalize == 1)
  int heads, tq, tk, q_offset, k_offset, causal, normalize;
  int ld;               // the (padded) head dim: the row length of q, k, v, o, out
  float scale;
};

__device__ __forceinline__ bool causal_ok(const FwdArgs& a, int qg, int kg) {
  return !a.causal || a.q_offset + qg >= a.k_offset + kg;
}

__device__ __forceinline__ bool visible(const FwdArgs& a, const float* km, int qg, int kg) {
  if (kg >= a.tk) return false;
  if (km != nullptr && !(km[kg] > 0.f)) return false;
  return causal_ok(a, qg, kg);
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : NEG_INF;
}

// ------------------------------------------------------------------ f32
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s += q k^T over the D columns of the tiles: the thread's rows ty + 16 i
// and keys tx + 16 j.
template <int D>
__device__ __forceinline__ void qk_dots_f32(float (*Qs)[D + 1], float (*Ks)[D + 1], int tx,
                                            int ty, float (&s)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = Qs[ty + 16 * i][d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = Ks[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
}

template <int D>
constexpr size_t fwd_f32_smem() {
  return (size_t)(3 * 64 * (D + 1) + 64 * (BK + 1)) * sizeof(float);
}

// WIDE: the block's slab of D columns (blockIdx.z) of rows a.ld long; the
// scores sum over every slab (q and k tiles reloaded per slab), v is loaded
// at the block's own slab, and slab 0 writes m, l (or lse).
template <int D, bool WIDE>
__global__ void __launch_bounds__(F_THREADS)
fa_fwd_f32_kernel(FwdArgs a) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float (*Qs)[LD] = reinterpret_cast<float (*)[LD]>(flash_smem);
  float (*Ks)[LD] = Qs + BQ;
  float (*Vs)[LD] = Ks + BK;
  float (*Ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(Vs + BK);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.tq * ld;
  const float* k = static_cast<const float*>(a.k) + (size_t)bh * a.tk * ld;
  const float* v = static_cast<const float*>(a.v) + (size_t)bh * a.tk * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  if constexpr (!WIDE) load_rows_f32<D>(Qs, q, q0, BQ, a.tq, tid, F_THREADS);

  float acc[4][NJ], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_f32<D>(Qs, q + c, q0, BQ, a.tq, tid, F_THREADS, ld);
        load_rows_f32<D>(Ks, k + c, k0, BK, a.tk, tid, F_THREADS, ld);
        if (c + D == ld) load_rows_f32<D>(Vs, v + col0, k0, BK, a.tk, tid, F_THREADS, ld);
        __syncthreads();
        qk_dots_f32<D>(Qs, Ks, tx, ty, s);
      }
    } else {
      load_rows_f32<D>(Ks, k, k0, BK, a.tk, tid, F_THREADS);
      load_rows_f32<D>(Vs, v, k0, BK, a.tk, tid, F_THREADS);
      __syncthreads();
      qk_dots_f32<D>(Qs, Ks, tx, ty, s);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q0 + ty + 16 * i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(a, km, qg, k0 + tx + 16 * j);
        s[i][j] = vis[j] ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mrow[i], half_warp_max(mx));
      const bool alive = m_new > NEG_INF * 0.5f;
      const float corr = alive ? expf(mrow[i] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (vis[j] && alive) ? expf(s[i][j] - m_new) : 0.f;
        Ps[ty + 16 * i][tx + 16 * j] = p;
        rs += p;
      }
      lrow[i] = lrow[i] * corr + half_warp_sum(rs);
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                 // the whole p tile is written

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = Vs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg;
    const bool stats = tx == 0 && (!WIDE || blockIdx.z == 0);
    if (a.normalize) {
      float* out = static_cast<float*>(a.out) + row * ld + col0;
      const float den = fmaxf(lrow[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[tx + 16 * j] = acc[i][j] / den;
      if (stats) a.lse[row] = lse_of(mrow[i], lrow[i]);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j) a.o[row * ld + col0 + tx + 16 * j] = acc[i][j];
      if (stats) {
        a.m[row] = mrow[i];
        a.l[row] = lrow[i];
      }
    }
  }
}

// ----------------------------------------------------------------- bf16
// The forward's tensor maps (q, k, v: bf16 [BH, T, ld]) and arguments.
struct alignas(64) FwdTmaArgs {
  CUtensorMap q, k, v;
  FwdArgs a;
};

// The max (or min) of s over each of the thread's two rows (entries 4 j +
// 2 h + e), across the four lanes that share the rows; in four partials a
// row, for shorter chains.
template <bool MAX>
__device__ __forceinline__ float pick(float x, float y) { return MAX ? fmaxf(x, y) : fminf(x, y); }

template <bool MAX, int N>
__device__ __forceinline__ float2 row_extremes(const float (&sc)[N]) {
  float m[2][4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, u = 2 * (j & 1) + (e & 1);
      m[h][u] = j < 2 ? sc[4 * j + e] : pick<MAX>(m[h][u], sc[4 * j + e]);
    }
  float r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = pick<MAX>(pick<MAX>(m[h][0], m[h][1]), pick<MAX>(m[h][2], m[h][3]));
    r[h] = pick<MAX>(r[h], __shfl_xor_sync(0xffffffffu, r[h], 1));
    r[h] = pick<MAX>(r[h], __shfl_xor_sync(0xffffffffu, r[h], 2));
  }
  return make_float2(r[0], r[1]);
}

// Keys of a tile in the bf16 kernel: 128, which halves the tiles (and their
// waits) of 64; 64 at D = 128, where a stage of 128 keys would leave room
// for two stages only, and where (WIDE) o of 128 columns beside s of 128
// keys spills and ptxas serializes the wgmma.
template <int D, bool WIDE>
__host__ __device__ constexpr int fwd_keys() { return D == 128 ? 64 : 128; }

// One block owns QB = 128 query rows (blockIdx.x) of one (batch, head)
// (blockIdx.y) and slab blockIdx.z of the output columns, and walks the
// tiles of KN keys up to the last one its rows see; each consumer warpgroup
// owns 64 of the rows, with o, the running max m (of the scaled scores, in
// natural units) and its share of l in registers.  Per key tile:
//   s = q k^T                 wgmma, both operands from shared memory
//                             (WIDE: summed over the CH-column chunks)
//   m_new = max(m, max_k s scale), p = 2^(s scale log2(e) - m_new log2(e))
//   o = o 2^((m - m_new) log2(e)) + p v    (p rounded to bf16 in the
//                             registers: the A operand of wgmma; v the
//                             N-major B from shared memory)
// A warpgroup whose rows all lie past Tq, or before the tile's first key
// under causal, only passes the tile on: it would add nothing.
template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_fwd_bf16_kernel(const __grid_constant__ FwdTmaArgs p) {
  constexpr int KN = fwd_keys<D, WIDE>(), NS = KN / 2;   // NS: a thread's entries of s
  using L = QTileSmem<D, WIDE, 1, KN>;
  constexpr int QB = L::QB;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  const QTileRing<L> r(smem_1024(flash_smem));
  const FwdArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * QB;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const int n_kt =
      key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + QB, a.tq) - 1, KN);
  if (tid == 0) r.init();
  __syncthreads();

  if (warpgroup() == NWG) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid >= CONSUMERS + 32) return;
    const CUtensorMap* const qm[1] = {&p.q};
    const CUtensorMap* const km[1] = {&p.k};
    q_tile_producer<D, WIDE, 1, KN>(r, qm, km, &p.k, &p.v, &p.v,
                                    a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr,
                                    a.tk, n_kt, q0, bh, col0, ld);
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warpgroup(), wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int qg[2] = {q0 + 64 * wg + 16 * wq + g, q0 + 64 * wg + 16 * wq + g + 8};
  const int q_first = q0 + 64 * wg + 16 * wq;   // this warp's first row
  // this warpgroup's rows: none below Tq, or the last of them
  const bool no_rows = q0 + 64 * wg >= a.tq;
  const int wg_last = min(q0 + 64 * wg + 63, a.tq - 1);
  float o[D / 2];                               // rows qg[h], columns 8 j + 2 t + e
  zero(o);
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};   // l: this thread's keys
  const bool pos = a.scale > 0.f;
  const float sl2 = a.scale * LOG2E, unseen = pos ? -INFINITY : INFINITY;
  mbar_wait(r.res_bar, 0);
  int it = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    const bool idle = no_rows || (a.causal && a.q_offset + wg_last < a.k_offset + k0);
    // s = q k^T: rows qg[h], keys 8 j + 2 t + e (the first product of a
    // tile overwrites sc)
    float sc[NS];
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += CH, ++it) {
        const int s = it % L::STAGES;
        const uint32_t sa = r.stage(s);
        mbar_wait(r.full + 8 * s, (it / L::STAGES) & 1);
        if (!idle) {
          reg_fence(sc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < CH / 16; ++kk)
            wgmma_kk(sc, desc_k<CH, QB>(sa, 64 * wg, kk * 16),
                     desc_k<CH, KN>(sa + QB * CH * 2, 0, kk * 16), c > 0 || kk > 0);
          wg_commit();
          wg_wait();
          reg_fence(sc);
        }
        if (lane == 0) mbar_arrive(r.empty + 8 * s);
      }
    }
    const int s = it % L::STAGES;
    const uint32_t sa = r.stage(s);
    const uint32_t vt = WIDE ? sa : sa + KN * D * 2;   // v's rows at the block's columns
    mbar_wait(r.full + 8 * s, (it / L::STAGES) & 1);
    if (!idle) {
      if constexpr (!WIDE) {
        reg_fence(sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_kk(sc, desc_k<D, QB>(r.res, 64 * wg, kk * 16), desc_k<D, KN>(sa, 0, kk * 16),
                   kk > 0);
        wg_commit();
        wg_wait();
        reg_fence(sc);
      }
      // the raw scores s, -inf where a key is not seen (+inf under a negative
      // scale, so that s scale is -inf): the per-entry rule only on a tile
      // that the Tk tail, the key mask or the causal rule cuts.  The tile's
      // max of s scale is scale times the max of s (the min under a negative
      // scale), and p = 2^(s scale log2(e) - m log2(e)) one FMA and one exp2
      const float* aux = r.aux(s);
      const bool exact =
          aux[KN] > 0.f && (!a.causal || a.q_offset + q_first >= a.k_offset + k0 + KN - 1);
      if (!exact) {
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 8 * j + 2 * t + (e & 1);
            if (!(aux[kl] > 0.f && causal_ok(a, qg[e >> 1], k0 + kl))) sc[4 * j + e] = unseen;
          }
      }
      const float2 ext = pos ? row_extremes<true>(sc) : row_extremes<false>(sc);
      // the online softmax: a row that has seen no key yet keeps m = NEG_INF
      // and takes p = 0 (its scores are -inf against a shift of 0)
      float corr[2], shift[2], ls[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // -inf times scale where the row sees no key of the tile
        const float m_new = fmaxf(m_run[h], (h ? ext.y : ext.x) * a.scale);
        corr[h] = ex2((m_run[h] - m_new) * LOG2E);
        shift[h] = m_new > NEG_INF * 0.5f ? m_new * LOG2E : 0.f;
        m_run[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, i = 4 * j + e, u = 2 * (j & 1) + (e & 1);
          const float pe = ex2(fmaf(sc[i], sl2, -shift[h]));
          sc[i] = pe;
          ls[h][u] = j < 2 ? pe : ls[h][u] + pe;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_run[h] = l_run[h] * corr[h] + ((ls[h][0] + ls[h][1]) + (ls[h][2] + ls[h][3]));
      // o keeps its scale in the common case that no row's max moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
      }
      uint32_t pa[KN / 16][4];
      a_operands<KN>(pa, sc);
      // o += p v
      reg_fence(o);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs(o, pa[kk], desc_n<D, KN>(vt, kk * 16, 0), 1);
      wg_commit();
      wg_wait();
      reg_fence(o);
      reg_fence(pa);
    }
    if (lane == 0) mbar_arrive(r.empty + 8 * s);
    ++it;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qg[h] >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg[h];
    const bool stats = t == 0 && (!WIDE || blockIdx.z == 0);
    if (a.normalize) {
      uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + row * ld + col0);
      const float den = fmaxf(l, 1e-20f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        out[4 * j + t] = pack_bf16(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
      if (stats) a.lse[row] = lse_of(m_run[h], l);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(a.o + row * ld + col0 + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (stats) {
        a.m[row] = m_run[h];
        a.l[row] = l;
      }
    }
  }
}

template <int D, bool BF16, bool WIDE = false>
int launch(const void* q, const void* k, const void* v, const void* kmask, void* o, void* m,
           void* l, void* out, void* lse, int bh, int heads, int tq, int tk, int q_offset,
           int k_offset, int causal, int normalize, int ld, float scale, void* stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = static_cast<const float*>(kmask);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.normalize = normalize;
  a.ld = ld;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if constexpr (BF16) {
    using L = QTileSmem<D, WIDE, 1, fwd_keys<D, WIDE>()>;
    FwdTmaArgs p;
    p.a = a;
    if (!(encode_map(&p.q, q, bh, tq, ld) && encode_map(&p.k, k, bh, tk, ld) &&
          encode_map(&p.v, v, bh, tk, ld)))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((tq + L::QB - 1) / L::QB, bh, WIDE ? ld / D : 1);
    return launch_kernel(fa_fwd_bf16_kernel<D, WIDE>, grid, SM90_THREADS, L::BYTES, s, p);
  } else {
    const dim3 grid((tq + BQ - 1) / BQ, bh, WIDE ? ld / D : 1);
    return launch_kernel(fa_fwd_f32_kernel<D, WIDE>, grid, F_THREADS, fwd_f32_smem<D>(), s, a);
  }
}

template <bool BF16>
int dispatch(int d, const void* q, const void* k, const void* v, const void* kmask, void* o,
             void* m, void* l, void* out, void* lse, int bh, int heads, int tq, int tk,
             int q_offset, int k_offset, int causal, int normalize, float scale, void* stream) {
  switch (d) {
    case 32:
      return launch<32, BF16>(q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset,
                              k_offset, causal, normalize, d, scale, stream);
    case 64:
      return launch<64, BF16>(q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset,
                              k_offset, causal, normalize, d, scale, stream);
    case 128:
      return launch<128, BF16>(q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset,
                               k_offset, causal, normalize, d, scale, stream);
  }
  if (wide_head_dim(d))
    return launch<128, BF16, true>(q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk,
                                   q_offset, k_offset, causal, normalize, d, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_fwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            void* o, void* m, void* l, void* out, void* lse, int bh, int heads,
                            int tq, int tk, int q_offset, int k_offset, int causal,
                            int normalize, int d, float scale, void* stream) {
  return dispatch<false>(d, q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset,
                         k_offset, causal, normalize, scale, stream);
}

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             void* o, void* m, void* l, void* out, void* lse, int bh, int heads,
                             int tq, int tk, int q_offset, int k_offset, int causal,
                             int normalize, int d, float scale, void* stream) {
  return dispatch<true>(d, q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset,
                        k_offset, causal, normalize, scale, stream);
}

}  // extern "C"
