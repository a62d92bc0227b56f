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
// by operations, on the tensor cores.  The JAX kernel asks for
// Precision.HIGHEST in f32, so the f32 kernel runs every product in three
// TF32 passes (flash_attention_sm90.cuh): 3 x 495 TFLOP/s of TF32, 165
// TFLOP/s of f32-accurate work (the CUDA cores' FMA peak is 67 TFLOP/s);
// bf16 runs at 989 TFLOP/s.
//
// What the design does about it: the [Tq, Tk] scores never leave the SM.
// The TPU kernel walks the K blocks as a sequential grid axis and carries
// (acc, m, l) in VMEM scratch; here one thread block owns 128 query rows of
// one (batch, head) and loops over the key tiles itself, with the running
// (m, l) and the accumulator in registers.  K tiles wholly in a causal row
// tile's future are never loaded (the loop ends before them).  Both dtypes
// run on Hopper's tensor-core path: one producer warpgroup and two consumer
// warpgroups of 64 rows each; a producer thread keeps TMA loads of the key
// tiles in flight through a ring of stages behind mbarriers, and the
// consumers run s = q k^T as wgmma, the online softmax in the accumulator
// registers (exp2 with scale log2(e) folded in, the per-entry visibility
// rule only on tiles the Tk tail, the key mask or the causal rule cut, o
// rescaled only when a row's max moved), and o += p v as wgmma with p as the
// register A operand.  The two warpgroups run apart, so one's softmax
// overlaps the other's products.
//   * bf16 (flash_attention_sm90.cuh's query-tile ring): q in once by TMA,
//     then k and v of every key tile (128 keys below D = 128, 64 from
//     D = 128 on); s from swizzled shared memory; p rounded to bf16, as the
//     JAX kernel does.
//   * f32: tiles of 64 keys.  The producer warpgroup's other three warps
//     prepare each stage the TMA filled: k split in place into its TF32 hi
//     and lo halves, v transposed into v^T (hi | lo), the only layout TF32
//     wgmma takes for o += p v's B (its keys permuted within each 8 so that
//     p's A operand can come straight from the accumulator, key_column),
//     and the keys' visibility.  Below D = 128 q's rows stay in shared
//     memory and each product reads them by ldmatrix, 32 columns at a time,
//     split in registers; from D = 128 on the block owns a 64-column slab of
//     o (ptxas gives each of 384 threads 168 registers, which hold 64
//     columns of o beside p and a product's accumulator, and spill at 128),
//     and q streams in with k in 64-column chunks.  Each tile's p v goes to
//     a fresh accumulator, added to o in f32: the tensor core's adds round
//     toward zero, and chained over every key tile that bias grows with
//     Tk.  Accuracy: each product keeps about 2^-20 of sum |a_i b_i|; the
//     outputs read within 2e-5 of the plain f32 version (chip_smoke.py).
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// column slabs (flash_attention.cuh; in bf16 of 128 columns, the scores
// summed over 64-column chunks of q and k streamed through the ring; in f32
// of 64, as D = 128 does).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for another D, or for tensor maps cuTensorMapEncodeTiled refuses).

#include <type_traits>

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

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

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : NEG_INF;
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

// The online softmax of one tile of KN keys (k0..) in the accumulators:
// s (rows qg[h], keys 8 j + 2 t + e) becomes p = 2^(s scale log2(e) -
// m log2(e)) in place, with the running max m (of the scaled scores, in
// natural units), this thread's share of l and o (rows qg[h]) brought up to
// date.  aux: the tile's keys' visibility, and at aux[KN] whether all are
// seen; q_first: the warp's first row; sl2 = scale log2(e), and unseen the
// score of a key not seen: -inf (+inf under a negative scale).
template <int KN, int NO>
__device__ __forceinline__ void online_softmax(const FwdArgs& a, float (&sc)[KN / 2],
                                               float (&o)[NO], float (&m_run)[2],
                                               float (&l_run)[2], const float* aux,
                                               const int (&qg)[2], int q_first, int k0, int t,
                                               float sl2, float unseen) {
  const bool pos = unseen < 0.f;
  // the raw scores s, -inf where a key is not seen (+inf under a negative
  // scale, so that s scale is -inf): the per-entry rule only on a tile
  // that the Tk tail, the key mask or the causal rule cuts.  The tile's
  // max of s scale is scale times the max of s (the min under a negative
  // scale), and p = 2^(s scale log2(e) - m log2(e)) one FMA and one exp2
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
    for (int j = 0; j < NO / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
  }
}

// The block's rows qg[h] of the output (columns col0 + 8 j + 2 t + e of
// rows ld long; the inputs' dtype T when normalized) and, where `stats`
// (lane t == 0 of slab 0), their m and l, or lse.
template <typename T, int NO>
__device__ __forceinline__ void write_rows(const FwdArgs& a, const float (&o)[NO],
                                           const float (&m_run)[2], const float (&l_run)[2],
                                           const int (&qg)[2], int bh, int ld, int col0, int t,
                                           bool slab0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qg[h] >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg[h];
    const bool stats = t == 0 && slab0;
    if (a.normalize) {
      // pairs of columns: 32-bit words of bf16, or float2
      auto* out = reinterpret_cast<std::conditional_t<sizeof(T) == 2, uint32_t, float2>*>(
          static_cast<T*>(a.out) + row * ld + col0);
      const float den = fmaxf(l, 1e-20f);
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        const float x = o[4 * j + 2 * h] / den, y = o[4 * j + 2 * h + 1] / den;
        if constexpr (sizeof(T) == 2)
          out[4 * j + t] = pack_bf16(x, y);
        else
          out[4 * j + t] = make_float2(x, y);
      }
      if (stats) a.lse[row] = lse_of(m_run[h], l);
    } else {
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<float2*>(a.o + row * ld + col0 + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (stats) {
        a.m[row] = m_run[h];
        a.l[row] = l;
      }
    }
  }
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
  const float sl2 = a.scale * LOG2E, unseen = a.scale > 0.f ? -INFINITY : INFINITY;
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
      online_softmax<KN>(a, sc, o, m_run, l_run, r.aux(s), qg, q_first, k0, t, sl2, unseen);
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

  write_rows<bf16>(a, o, m_run, l_run, qg, bh, ld, col0, t, !WIDE || blockIdx.z == 0);
}

// ------------------------------------------------------------------ f32
// Shared memory of the f32 forward: below D = 128 the block's q rows as
// loaded [QB, D] (resident), then a ring of STAGES slots, each with its
// keys' visibility (aux: KN + 1 floats), and the full, ready and empty
// barriers of every slot (and the resident rows' barrier).  Below D = 128 a
// slot holds a key tile's k (hi | lo), v as loaded and v^T (hi | lo).  From
// D = 128 on (CHUNKED: the block's slab of D output columns of rows ld
// long), a chunk slot holds q as loaded [QB, CH] and k (hi | lo) [KN, CH]
// for one CH-column chunk of the scores, and the product slot v as loaded
// at the block's columns and its v^T (hi | lo).  CHUNKED runs with D = 64:
// ptxas gives each of a block's 384 threads 168 registers, which hold 64
// columns of o beside p's A operand and a product's fresh accumulator, and
// spill with 128.
template <int D, bool CHUNKED>
struct FwdF32Smem {
  static constexpr int QB = TR * NWG, KN = 64, CH = 64, PREP = WG_THREADS - 32;
  static constexpr int RES = CHUNKED ? 0 : QB * D * 4;
  static constexpr int T = KN * D * 4;                         // a [KN, D] f32 tile
  static constexpr int K_HI = 0, K_LO = T, V_IN = 2 * T, VT_HI = 3 * T, VT_LO = 4 * T;
  static constexpr int C_Q = 0, C_K_HI = QB * CH * 4, C_K_LO = C_K_HI + KN * CH * 4;
  static constexpr int CHUNK = C_K_LO + KN * CH * 4;           // a chunk slot's bytes
  static constexpr int SLOT = CHUNKED ? (CHUNK > 3 * T ? CHUNK : 3 * T) : 5 * T;
  static constexpr int AUX = 4 * (KN + 2);                     // 8-byte aligned
  static constexpr int FIT = (SMEM_MAX - 2048 - RES) / (SLOT + AUX + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING = RES, BARS = RING + STAGES * (SLOT + AUX);
  static constexpr size_t BYTES = 1024 + BARS + 24 * STAGES + 8;
};

// s += q k^T over W columns, 32 at a time: A = q (the warp's 16 rows from
// m0 of an R-row tile as loaded at the shared address q, split in
// registers), B = k (hi | lo) [64, W]
template <int R, int W>
__device__ __forceinline__ void scores(float (&sc)[32], uint32_t q, uint32_t k_hi, uint32_t k_lo,
                                       int m0, int lane) {
#pragma unroll
  for (int c = 0; c < W; c += 32) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_split_rows<R>(ah[kk], al[kk], q, m0, c + 8 * kk, lane);
    reg_fence(sc);
    reg_fence(ah);
    reg_fence(al);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3(sc, ah[kk], al[kk], desc_f32<TR>(k_hi, c + 8 * kk), desc_f32<TR>(k_lo, c + 8 * kk));
    wg_commit();
    wg_wait();
    reg_fence(sc);
    reg_fence(ah);
    reg_fence(al);
  }
}

// One block owns QB = 128 query rows (blockIdx.x) of one (batch, head)
// (blockIdx.y) and slab blockIdx.z of the output columns (CHUNKED), and
// walks the tiles of KN = 64 keys up to the last one its rows see; each
// consumer warpgroup owns 64 of the rows, with o, m and its share of l in
// registers.  Per key tile, in three TF32 passes (flash_attention_sm90.cuh):
//   s = q k^T      A = q, read from the resident rows (CHUNKED: from the
//                  chunk slots) 32 columns at a time and split in registers;
//                  B = k (hi | lo)
//   the online softmax of the bf16 kernel (online_softmax)
//   o += p v       A = p, split where the accumulator left it: lane t holds
//                  keys 2 t and 2 t + 1 of each 8, which serve as the A
//                  operand's columns t and t + 4, so v^T's keys are permuted
//                  the same way within each 8 (key_column); B = v^T (hi | lo)
// The producer warpgroup: one thread issues each slot's TMA loads, warps 1-3
// prepare the slot once it is full (k split in place, v transposed and
// split, the keys' visibility) and mark it ready; the consumers release it.
// A warpgroup with no rows left to serve (past Tq, or before the tile's
// first key under causal) only passes the tile on.
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_fwd_f32_kernel(const __grid_constant__ FwdTmaArgs p) {
  using L = FwdF32Smem<D, CHUNKED>;
  constexpr int QB = L::QB, KN = L::KN, CH = L::CH, ST = L::STAGES;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  unsigned char* sp = smem_1024(flash_smem);
  unsigned char* ring = sp + L::RING;
  const uint32_t su = smem_u32(ring);
  const uint32_t full = smem_u32(sp) + L::BARS, ready = full + 8 * ST, empty = ready + 8 * ST,
                 res_bar = empty + 8 * ST;
  const FwdArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * QB;
  const int ld = CHUNKED ? a.ld : D, col0 = CHUNKED ? blockIdx.z * D : 0;
  const int chunks = CHUNKED ? ld / CH : 0;   // score chunks of a key tile
  const int n_kt =
      key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + QB, a.tq) - 1, KN);
  auto aux = [&](int s) { return reinterpret_cast<float*>(ring + ST * L::SLOT + s * L::AUX); };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, L::PREP);
      mbar_init(empty + 8 * s, NWG * 4);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == NWG) {
    // ---------------------------------------------------------- producer
    const int pw = tid - CONSUMERS;
    int it = 0;
    if (pw == 0) {
      // the block's q rows, then each slot's TMA loads in the consumers' order
      if constexpr (!CHUNKED) {
        mbar_expect_tx(res_bar, L::RES);
        tma_f32<D, QB>(smem_u32(sp), &p.q, res_bar, 0, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * KN;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          const uint32_t st = su + s * L::SLOT, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, L::C_K_LO);   // q, and k as loaded
          tma_f32<CH, QB>(st + L::C_Q, &p.q, bar, c * CH, q0, bh);
          tma_f32<CH, KN>(st + L::C_K_HI, &p.k, bar, c * CH, k0, bh);
        }
        const int s = it % ST;
        const uint32_t st = su + s * L::SLOT, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
        if constexpr (CHUNKED) {
          mbar_expect_tx(bar, L::T);
          tma_f32<D, KN>(st, &p.v, bar, col0, k0, bh);
        } else {
          mbar_expect_tx(bar, 2 * L::T);
          tma_f32<D, KN>(st + L::K_HI, &p.k, bar, 0, k0, bh);
          tma_f32<D, KN>(st + L::V_IN, &p.v, bar, 0, k0, bh);
        }
        ++it;
      }
      return;
    }
    if (pw < 32) return;
    // prep
    const int pt = pw - 32;
    const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * KN;
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % ST;
        unsigned char* st = ring + s * L::SLOT;
        mbar_wait(full + 8 * s, (it / ST) & 1);
        split_in_place(st + L::C_K_HI, st + L::C_K_LO, KN * CH * 4, pt, L::PREP);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready + 8 * s);
      }
      const int s = it % ST;
      unsigned char* st = ring + s * L::SLOT;
      mbar_wait(full + 8 * s, (it / ST) & 1);
      if constexpr (CHUNKED) {
        // v at the block's columns, as loaded at the slot's start, then v^T
        transpose_split<KN, D, true>(st, st + L::T, st + 2 * L::T, pt, L::PREP);
      } else {
        split_in_place(st + L::K_HI, st + L::K_LO, L::T, pt, L::PREP);
        transpose_split<KN, D, true>(st + L::V_IN, st + L::VT_HI, st + L::VT_LO, pt, L::PREP);
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
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warpgroup(), wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * wq + g;      // this thread's first row of the block
  const int qg[2] = {q0 + row0, q0 + row0 + 8};
  const int q_first = q0 + 64 * wg + 16 * wq;  // this warp's first row
  const bool no_rows = q0 + 64 * wg >= a.tq;
  const int wg_last = min(q0 + 64 * wg + 63, a.tq - 1);
  float o[D / 2];                              // rows qg[h], columns 8 j + 2 t + e
  zero(o);
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};   // l: this thread's keys
  const float sl2 = a.scale * LOG2E, unseen = a.scale > 0.f ? -INFINITY : INFINITY;
  if constexpr (!CHUNKED) mbar_wait(res_bar, 0);
  int it = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    const bool idle = no_rows || (a.causal && a.q_offset + wg_last < a.k_offset + k0);
    float sc[KN / 2];                          // s: rows qg[h], keys 8 j + 2 t + e
    zero(sc);
    if constexpr (CHUNKED) {
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % ST;
        const uint32_t st = su + s * L::SLOT;
        mbar_wait(ready + 8 * s, (it / ST) & 1);
        if (!idle)
          scores<QB, CH>(sc, st + L::C_Q, st + L::C_K_HI, st + L::C_K_LO, q_first - q0, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
    const int s = it % ST;
    const uint32_t st = su + s * L::SLOT;
    // v^T (hi | lo): D rows, KN columns
    const uint32_t vt = st + (CHUNKED ? L::T : L::VT_HI), vt_lo = vt + L::T;
    mbar_wait(ready + 8 * s, (it / ST) & 1);
    if (!idle) {
      if constexpr (!CHUNKED)
        scores<QB, D>(sc, smem_u32(sp), st + L::K_HI, st + L::K_LO, q_first - q0, lane);
      online_softmax<KN>(a, sc, o, m_run, l_run, aux(s), qg, q_first, k0, t, sl2, unseen);
      // p as the A operand of each 8-key step j: keys 2 t, 2 t + 1 of rows
      // qg[0], qg[1] (entries 4 j + e) at its columns t, t + 4
      uint32_t ph[KN / 8][4], pl[KN / 8][4];
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        split_tf32(sc[4 * j], ph[j][0], pl[j][0]);
        split_tf32(sc[4 * j + 2], ph[j][1], pl[j][1]);
        split_tf32(sc[4 * j + 1], ph[j][2], pl[j][2]);
        split_tf32(sc[4 * j + 3], ph[j][3], pl[j][3]);
      }
      // o += p v, 32 columns at a time: the tile's product in a fresh
      // accumulator ot, then added to o in f32 (the tensor core's adds round
      // toward zero: chained over every key tile into o, that bias would
      // grow with Tk); ot of 32 columns keeps the block within its 168
      // registers a thread
#pragma unroll
      for (int c = 0; c < D; c += 32) {
        float ot[16];
        zero(ot);
        reg_fence(ot);
        reg_fence(ph);
        reg_fence(pl);
        wg_fence();
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
          mma3(ot, ph[j], pl[j], desc_f32<D>(vt + c * 128, 8 * j),
               desc_f32<D>(vt_lo + c * 128, 8 * j));
        wg_commit();
        wg_wait();
        reg_fence(ot);
        reg_fence(ph);
        reg_fence(pl);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c / 2 + i] += ot[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    ++it;
  }

  write_rows<float>(a, o, m_run, l_run, qg, bh, ld, col0, t, !CHUNKED || blockIdx.z == 0);
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
    // from D = 128 on, in slabs of 64 columns: one template
    constexpr bool CHUNKED = D == 128;
    constexpr int SL = CHUNKED ? 64 : D;
    using L = FwdF32Smem<SL, CHUNKED>;
    FwdTmaArgs p;
    p.a = a;
    if (!(encode_f32_map(&p.q, q, bh, tq, ld) && encode_f32_map(&p.k, k, bh, tk, ld) &&
          encode_f32_map(&p.v, v, bh, tk, ld)))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((tq + L::QB - 1) / L::QB, bh, ld / SL);
    return launch_kernel(fa_fwd_f32_kernel<SL, CHUNKED>, grid, SM90_THREADS, L::BYTES, s, p);
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
