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
// (acc, m, l) in VMEM scratch; here one thread block owns a 64-row tile of
// queries of one (batch, head) and loops over 64-key tiles itself, with the
// running (m, l) and the accumulator in registers.  K tiles wholly in a
// causal row tile's future are never loaded (the loop ends before them).
//   * f32: 256 threads, each owning 4 rows x 4 columns (rows ty + 16 i,
//     columns tx + 16 j, conflict-free on the odd-length padded rows) of
//     the score tile and 4 x D/16 of the output, FMA in f32 on the CUDA
//     cores.  The row max and sum are reduced over the 16 lanes that share
//     a row; p goes through shared memory to the p.v product.
//   * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate), each
//     owning 16 query rows.  Scores, p and the output stay in registers:
//     the accumulator layout of q.k^T is the operand layout of p.v, so p
//     is rounded to bf16 (as the JAX kernel does) and fed back directly.
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// 128-column slabs (flash_attention.cuh).  A simple kernel: no
// cp.async/TMA pipelining and no wgmma yet.
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for another D).

#include "flash_attention.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block

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

__device__ __forceinline__ bool visible(const FwdArgs& a, const float* km, int qg, int kg) {
  if (kg >= a.tk) return false;
  if (km != nullptr && !(km[kg] > 0.f)) return false;
  if (a.causal && a.q_offset + qg < a.k_offset + kg) return false;
  return true;
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
// s += q k^T over columns [16 kk, 16 kk + 16) of the tiles, for this warp's
// 16 query rows (their A fragment qf): the key rows read as column-major k^T.
template <int D>
__device__ __forceinline__ void qk_dots_bf16(float (&s)[BK / 8][4], const uint32_t (&qf)[4],
                                             bf16 (*Ks)[D + 8], int kk, int lane) {
#pragma unroll
  for (int np = 0; np < BK / 16; ++np) {
    uint32_t b[4];
    bt_frag<D + 8>(b, Ks, np * 16, kk * 16, lane);
    mma_bf16(s[2 * np], qf, b[0], b[1]);
    mma_bf16(s[2 * np + 1], qf, b[2], b[3]);
  }
}

template <int D>
constexpr size_t fwd_bf16_smem() {
  return (size_t)3 * 64 * (D + 8) * sizeof(bf16) + BK;
}

// Fragment layout of mma.m16n8k16 (lane = 4 * g + t): an accumulator holds
// rows g and g + 8, columns 2t and 2t + 1 of its 16x8 tile; so a thread owns
// two query rows, and p's accumulators become the A operand of p.v in
// registers.  K rows are loaded as the column-major k^T (ldmatrix), V rows
// transposed (ldmatrix.trans).  WIDE: the block's slab of D columns
// (blockIdx.z), as in the f32 kernel; q rows are then read from shared
// memory at each use, one slab at a time.
template <int D, bool WIDE>
__global__ void __launch_bounds__(H_THREADS)
fa_fwd_bf16_kernel(FwdArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16 (*Qs)[LD] = reinterpret_cast<bf16 (*)[LD]>(flash_smem);
  bf16 (*Ks)[LD] = Qs + BQ;
  bf16 (*Vs)[LD] = Ks + BK;
  bool* key_ok = reinterpret_cast<bool*>(Vs + BK);   // the tile's keys: below Tk and unmasked

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int m0 = warp * 16;                       // this warp's 16 query rows
  const int qg[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.tq * ld;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bh * a.tk * ld;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bh * a.tk * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  uint32_t qa[WIDE ? 1 : D / 16][4];              // q rows as A fragments, per 16 of D
  if constexpr (!WIDE) {
    load_rows_bf16<D>(Qs, q, q0, BQ, a.tq, tid, H_THREADS);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) a_frag<LD>(qa[kk], Qs, m0, kk * 16, lane);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_bf16<D>(Qs, q + c, q0, BQ, a.tq, tid, H_THREADS, ld);
        load_rows_bf16<D>(Ks, k + c, k0, BK, a.tk, tid, H_THREADS, ld);
        if (c == 0 && tid < BK)
          key_ok[tid] = k0 + tid < a.tk && (km == nullptr || km[k0 + tid] > 0.f);
        if (c + D == ld) load_rows_bf16<D>(Vs, v + col0, k0, BK, a.tk, tid, H_THREADS, ld);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qf[4];
          a_frag<LD>(qf, Qs, m0, kk * 16, lane);
          qk_dots_bf16<D>(s, qf, Ks, kk, lane);
        }
      }
    } else {
      load_rows_bf16<D>(Ks, k, k0, BK, a.tk, tid, H_THREADS);
      load_rows_bf16<D>(Vs, v, k0, BK, a.tk, tid, H_THREADS);
      if (tid < BK) key_ok[tid] = k0 + tid < a.tk && (km == nullptr || km[k0 + tid] > 0.f);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) qk_dots_bf16<D>(s, qa[kk], Ks, kk, lane);
    }

    // mask, scale and the online softmax on rows qg[0], qg[1]
    float mx[2] = {NEG_INF, NEG_INF};
    unsigned vis[2] = {0u, 0u};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kl = n * 8 + 2 * t + (e & 1);
        const bool seen = key_ok[kl] && !(a.causal && a.q_offset + qg[h] < a.k_offset + k0 + kl);
        vis[h] |= (seen ? 1u : 0u) << (2 * n + (e & 1));
        s[n][e] = seen ? s[n][e] * a.scale : NEG_INF;
        mx[h] = fmaxf(mx[h], s[n][e]);
      }
    float m_new[2], corr[2], rs[2] = {0.f, 0.f};
    bool alive[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_run[h], mx[h]);
      alive[h] = m_new[h] > NEG_INF * 0.5f;
      corr[h] = alive[h] ? expf(m_run[h] - m_new[h]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = (((vis[h] >> (2 * n + (e & 1))) & 1u) && alive[h])
                            ? expf(s[n][e] - m_new[h]) : 0.f;
        s[n][e] = p;
        rs[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_run[h] = l_run[h] * corr[h] + rs[h];
      m_run[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p v, p rounded to bf16: two 8-key accumulator tiles make one
    // 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        b_frag<LD>(b, Vs, kk * 16, dp * 16, lane);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qg[h] >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg[h];
    const bool stats = t == 0 && (!WIDE || blockIdx.z == 0);
    if (a.normalize) {
      uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + row * ld + col0);
      const float den = fmaxf(l_run[h], 1e-20f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        out[(n * 8 + 2 * t) / 2] = pack_bf16(o[n][2 * h] / den, o[n][2 * h + 1] / den);
      if (stats) a.lse[row] = lse_of(m_run[h], l_run[h]);
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(a.o + row * ld + col0 + n * 8 + 2 * t) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (stats) {
        a.m[row] = m_run[h];
        a.l[row] = l_run[h];
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
  const dim3 grid((tq + BQ - 1) / BQ, bh, WIDE ? ld / D : 1);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if constexpr (BF16)
    return launch_kernel(fa_fwd_bf16_kernel<D, WIDE>, grid, H_THREADS, fwd_bf16_smem<D>(), s, a);
  else
    return launch_kernel(fa_fwd_f32_kernel<D, WIDE>, grid, F_THREADS, fwd_f32_smem<D>(), s, a);
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
