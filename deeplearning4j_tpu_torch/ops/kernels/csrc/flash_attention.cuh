// Device code shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bwd_split.cu): the bf16 tensor-core
// helpers, tile loaders, the backward's arguments and visibility rule, and
// the body of the backward's key-tile kernel, which the merged backward runs
// with its dq partials and the split backward's dk/dv kernel without.
//
// Every kernel is templated on the head dim D in {32, 64, 128}; the wrapper
// zero-pads any other head dim up to 128 to the next of these.  A head dim
// past 128 is zero-padded to a multiple of 128 (the row length ld in device
// memory) and runs in the WIDE form of the D = 128 template (of D = 64 for
// the bf16 merged backward): the output columns are split into slabs of D,
// one slab per block (blockIdx.z). Each block computes the scores s = q.k
// (and dp = dout.v in the backward) over the whole head dim, looping over it
// in D-column slabs of q, k, v and dout in shared memory, always in the same
// order, and accumulates only its own D columns of o (forward), or of dk, dv
// and dq (backward). So the accumulators and tiles stay those of the
// template, s and dp are recomputed once per slab, and m, l and lse come out
// the same in every slab (slab 0 writes them). All tiles live in dynamic
// shared memory (the launchers raise the 48 KB default where a template needs
// more).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;           // keys per tile
constexpr int F_THREADS = 256;   // f32 kernels: 16 x 16 threads over a 64 x 64 tile
constexpr int H_THREADS = 128;   // bf16 kernels: 4 warps of mma.sync

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- loaders
// rows [row0, row0 + n) of a [n_rows, ld] f32 matrix, D columns from src,
// into dst[n][D + 1]; zeros past n_rows.  The odd row length keeps a column
// read by 16 rows on 16 banks.
template <int D>
__device__ __forceinline__ void load_rows_f32(float (*dst)[D + 1], const float* src, int row0,
                                              int n, int n_rows, int tid, int threads,
                                              int ld = D) {
  for (int idx = tid; idx < n * (D / 4); idx += threads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * ld + c);
    dst[r][c] = v.x;
    dst[r][c + 1] = v.y;
    dst[r][c + 2] = v.z;
    dst[r][c + 3] = v.w;
  }
}

// the same for bf16 into dst[n][D + 8]: rows of 80, 144 or 272 bytes, so the
// 8 rows of an ldmatrix hit distinct banks
template <int D>
__device__ __forceinline__ void load_rows_bf16(bf16 (*dst)[D + 8], const bf16* src, int row0,
                                               int n, int n_rows, int tid, int threads,
                                               int ld = D) {
  for (int idx = tid; idx < n * (D / 8); idx += threads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// ------------------------------------------- bf16 tensor-core helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [row0, row0 + 16) x columns [c0, c0 + 16) of a
// bf16 tile, as mma.m16n8k16 takes it.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], bf16 (*tile)[LD], int row0, int c0,
                                       int lane) {
  ldsm_x4(r, &tile[row0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}

// The B fragments of two 8-column tiles of the column-major product
// tile^T: rows [row0, row0 + 16) of the tile are the columns, columns
// [c0, c0 + 16) the contraction.  r[0..1] feed the first 8, r[2..3] the next.
template <int LD>
__device__ __forceinline__ void bt_frag(uint32_t (&r)[4], bf16 (*tile)[LD], int row0, int c0,
                                        int lane) {
  ldsm_x4(r, &tile[row0 + (lane & 7) + ((lane >> 4) << 3)][c0 + ((lane >> 3) & 1) * 8]);
}

// The B fragments of two 8-column tiles of the row-major tile itself:
// rows [k0, k0 + 16) are the contraction, columns [c0, c0 + 16) the output.
template <int LD>
__device__ __forceinline__ void b_frag(uint32_t (&r)[4], bf16 (*tile)[LD], int k0, int c0,
                                       int lane) {
  ldsm_x4_t(r, &tile[k0 + (lane & 7) + ((lane >> 3) & 1) * 8][c0 + (lane >> 4) * 8]);
}

// ------------------------------------------------------------ backward
// For q [BH, Tq, D], k, v [BH, Tk, D], the cotangent dout [BH, Tq, D] of the
// normalized output, its log-sum-exp lse [BH, Tq] (NEG_INF on dead rows) and
// delta = rowsum(dout * out) [BH, Tq] (f32).  A key is visible to a row when
// its index is below Tk, its entry of the [B, Tk] key mask (if any) is above
// 0, and, under causal, q_offset + row >= k_offset + key.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [B, Tk] or null
  const void* dout;     // [BH, Tq, D], the inputs' dtype
  const float* lse;     // [BH, Tq]
  const float* delta;   // [BH, Tq]
  float* dq;            // [BH, Tq, D]              (split backward)
  float* dk;            // [BH, Tk, D]
  float* dv;            // [BH, Tk, D]
  float* dq_part;       // [n_kt, BH, tq_pad, D]    (merged backward)
  int bh, heads, tq, tk, tq_pad, q_offset, k_offset, causal;
  int ld;               // the (padded) head dim: every D above is this row length
  float scale;
};

__device__ __forceinline__ bool causal_ok(const BwdArgs& a, int qg, int kg) {
  return !a.causal || a.q_offset + qg >= a.k_offset + kg;
}

__device__ __forceinline__ bool visible(const BwdArgs& a, const float* km, int qg, int kg) {
  if (kg >= a.tk) return false;
  if (km != nullptr && !(km[kg] > 0.f)) return false;
  return causal_ok(a, qg, kg);
}

// One score entry's p and ds from s = q.k and dp = dout.v:
//     p  = exp(s * scale - lse)   on a visible key of a live row, else 0
//     ds = p * (dp - delta) * scale
__device__ __forceinline__ float2 p_ds(float s, float dp, float lse, float delta, bool seen,
                                       float scale) {
  const float p = (lse > NEG_INF * 0.5f && seen) ? expf(s * scale - lse) : 0.f;
  return make_float2(p, p * (dp - delta) * scale);
}

// The f32 score tile of 64 query rows (q0..) against a 64-key tile (k0..),
// from padded rows in shared memory: the thread's rows ty + 16 i and keys
// tx + 16 j of s = q k^T and dp = dout v^T by FMA on the CUDA cores, added
// to p and ds (score_dots_f32), then their p and ds (score_finish_f32).
template <int D>
__device__ __forceinline__ void score_dots_f32(float (*Qs)[D + 1], float (*dOs)[D + 1],
                                               float (*Ks)[D + 1], float (*Vs)[D + 1], int tx,
                                               int ty, float (&p)[4][4], float (&ds)[4][4]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[ty + 16 * i][d];
      oa[i] = dOs[ty + 16 * i][d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[tx + 16 * j][d];
      vb[j] = Vs[tx + 16 * j][d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qa[i], kb[j], p[i][j]);      // s
        ds[i][j] = fmaf(oa[i], vb[j], ds[i][j]);    // dp
      }
  }
}

__device__ __forceinline__ void score_finish_f32(const BwdArgs& a, const float* km,
                                                 const float* lse_s, const float* delta_s,
                                                 int q0, int k0, int tx, int ty,
                                                 float (&p)[4][4], float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool alive = lse_s[r] > NEG_INF * 0.5f;   // the key mask is read for live rows only
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 pd = p_ds(p[i][j], ds[i][j], lse_s[r], delta_s[r],
                             alive && visible(a, km, q0 + r, k0 + tx + 16 * j), a.scale);
      p[i][j] = pd.x;
      ds[i][j] = pd.y;
    }
  }
}

template <int D>
__device__ __forceinline__ void score_tile_f32(const BwdArgs& a, const float* km,
                                               float (*Qs)[D + 1], float (*dOs)[D + 1],
                                               float (*Ks)[D + 1], float (*Vs)[D + 1],
                                               const float* lse_s, const float* delta_s, int q0,
                                               int k0, int tx, int ty, float (&p)[4][4],
                                               float (&ds)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = ds[i][j] = 0.f;
  score_dots_f32<D>(Qs, dOs, Ks, Vs, tx, ty, p, ds);
  score_finish_f32(a, km, lse_s, delta_s, q0, k0, tx, ty, p, ds);
}

// The dq partial of a skipped query tile: BQ rows of D zeros, rows ld apart.
template <int D, int BQ>
__device__ __forceinline__ void zero_part(float* part, int ld, int tid, int threads) {
  for (int idx = tid; idx < BQ * D / 4; idx += threads)
    reinterpret_cast<float4*>(part + (size_t)(idx / (D / 4)) * ld)[idx % (D / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Under causal, a query tile whose last row comes before the key tile's
// first key sees none of it (the JAX kernels' last_q_pos >= first_k_pos).
__device__ __forceinline__ bool skipped(const BwdArgs& a, int q0, int bq, int k0) {
  return a.causal && a.q_offset + min(q0 + bq, a.tq) - 1 < a.k_offset + k0;
}

// Key tiles a query tile ending at row q_last visits: all of them, or under
// causal those up to the last key position q_last sees.
__device__ __forceinline__ int key_tiles(int tk, int causal, int q_offset, int k_offset,
                                         int q_last) {
  int n = (tk + BK - 1) / BK;
  if (causal) {
    const long long last = (long long)q_offset + q_last - k_offset;
    if (last < 0) return 0;
    n = min(n, (int)(last / BK) + 1);
  }
  return n;
}

// The bf16 key-tile kernel's query tile: 64 rows, 32 at D = 128, where each
// warp's dk and dv accumulators alone take 128 registers a thread.
template <int D>
__host__ __device__ constexpr int bwd_bf16_bq() { return D > 64 ? 32 : 64; }

template <int D>
constexpr size_t bwd_f32_smem() {
  return (size_t)(4 * 64 * (D + 1) + 2 * 64 * (BK + 1) + 2 * 64) * sizeof(float);
}

template <int D, bool DQ>
constexpr size_t bwd_bf16_smem() {
  constexpr int BQ = bwd_bf16_bq<D>();
  return (size_t)(2 * BK * (D + 8) + 2 * BQ * (D + 8) + (DQ ? BK * (BQ + 8) : 0)) * sizeof(bf16)
         + 2 * BQ * sizeof(float);
}

// One block owns a 64-key tile of one (batch, head) (blockIdx.x, blockIdx.y)
// and walks the 64-row query tiles, carrying dk and dv in registers (the TPU
// kernels' VMEM scratch):
//
//     p  = exp(q.k * scale - lse)   on visible keys of live rows, else 0
//     ds = p * (dout.v - delta) * scale
//     dv += p^T dout,  dk += ds^T q              (f32)
//
// With DQ (the merged backward) it also writes ds k of each query tile to
// its own [64, D] slice of dq_part, zeros for a skipped tile.  f32: each of
// 256 threads owns 4 x 4 entries of the score tile (rows ty + 16 i, keys
// tx + 16 j) and 4 x D/16 of dk, dv and the dq partial, FMA on the CUDA
// cores from padded rows.  WIDE: the block's slab of D columns (blockIdx.z)
// of rows a.ld long; the score tile sums over every slab (k and v tiles
// reloaded per slab with q and dout), then q, dout and k are reloaded at
// the block's own slab for the products.
template <int D, bool DQ, bool WIDE = false>
__device__ __forceinline__ void bwd_f32_body(const BwdArgs& a) {
  constexpr int LD = D + 1, NJ = D / 16, BQ = 64;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float (*Ks)[LD] = reinterpret_cast<float (*)[LD]>(flash_smem);
  float (*Vs)[LD] = Ks + BK;
  float (*Qs)[LD] = Vs + BK;
  float (*dOs)[LD] = Qs + BQ;
  float (*Ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(dOs + BQ);
  float (*dSs)[BK + 1] = Ps + BQ;
  float* lse_s = &dSs[BQ][0];
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BK;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.tq * ld;
  const float* k = static_cast<const float*>(a.k) + (size_t)bh * a.tk * ld;
  const float* v = static_cast<const float*>(a.v) + (size_t)bh * a.tk * ld;
  const float* dout = static_cast<const float*>(a.dout) + (size_t)bh * a.tq * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  if constexpr (!WIDE) {
    load_rows_f32<D>(Ks, k, k0, BK, a.tk, tid, F_THREADS);
    load_rows_f32<D>(Vs, v, k0, BK, a.tk, tid, F_THREADS);
  }

  float dk[4][NJ], dv[4][NJ];     // key rows ty + 16 i, columns col0 + tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_qt = (a.tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float* part =
        DQ ? a.dq_part + (((size_t)kt * a.bh + bh) * a.tq_pad + q0) * ld + col0 : nullptr;
    if (skipped(a, q0, BQ, k0)) {
      if constexpr (DQ && WIDE) {
        zero_part<D, BQ>(part, ld, tid, F_THREADS);
      } else if constexpr (DQ) {
        for (int idx = tid; idx < BQ * D / 4; idx += F_THREADS)
          reinterpret_cast<float4*>(part)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    __syncthreads();                 // the last tile's readers are done
    float p[4][4], ds[4][4];         // query rows ty + 16 i, key columns tx + 16 j
    if constexpr (WIDE) {
      if (tid < BQ) {
        const bool real = q0 + tid < a.tq;
        lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
        delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = ds[i][j] = 0.f;
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_f32<D>(Ks, k + c, k0, BK, a.tk, tid, F_THREADS, ld);
        load_rows_f32<D>(Vs, v + c, k0, BK, a.tk, tid, F_THREADS, ld);
        load_rows_f32<D>(Qs, q + c, q0, BQ, a.tq, tid, F_THREADS, ld);
        load_rows_f32<D>(dOs, dout + c, q0, BQ, a.tq, tid, F_THREADS, ld);
        __syncthreads();
        score_dots_f32<D>(Qs, dOs, Ks, Vs, tx, ty, p, ds);
      }
      score_finish_f32(a, km, lse_s, delta_s, q0, k0, tx, ty, p, ds);
      if (col0 + D != ld) {          // the products take the block's own slab
        __syncthreads();
        load_rows_f32<D>(Qs, q + col0, q0, BQ, a.tq, tid, F_THREADS, ld);
        load_rows_f32<D>(dOs, dout + col0, q0, BQ, a.tq, tid, F_THREADS, ld);
        if constexpr (DQ) load_rows_f32<D>(Ks, k + col0, k0, BK, a.tk, tid, F_THREADS, ld);
      }
    } else {
      load_rows_f32<D>(Qs, q, q0, BQ, a.tq, tid, F_THREADS);
      load_rows_f32<D>(dOs, dout, q0, BQ, a.tq, tid, F_THREADS);
      if (tid < BQ) {
        const bool real = q0 + tid < a.tq;
        lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
        delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
      }
      __syncthreads();
      score_tile_f32<D>(a, km, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, tx, ty, p, ds);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[ty + 16 * i][tx + 16 * j] = p[i][j];
        dSs[ty + 16 * i][tx + 16 * j] = ds[i][j];
      }
    __syncthreads();                 // p and ds complete

    // dv += p^T dout, dk += ds^T q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pa[4], sa[4], ob[NJ], qb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[r][ty + 16 * i];
        sa[i] = dSs[r][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ob[j] = dOs[r][tx + 16 * j];
        qb[j] = Qs[r][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
    if constexpr (DQ) {
      // dq partial = ds k: query rows ty + 16 i, columns tx + 16 j
      float dq[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float sa[4], kb[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[i] = dSs[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) kb[j] = Ks[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) part[(ty + 16 * i) * ld + tx + 16 * j] = dq[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty + 16 * i;
    if (kg >= a.tk) continue;
    const size_t row = ((size_t)bh * a.tk + kg) * ld + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      a.dk[row + tx + 16 * j] = dk[i][j];
      a.dv[row + tx + 16 * j] = dv[i][j];
    }
  }
}

// s^T += k q^T and dp^T += v dout^T over the D columns of the tiles in shared
// memory, the query rows read as column-major q^T, dout^T: this warp's 16
// keys (w0..) against the BQ queries, its k and v rows from the A fragments
// ka, va where KEEP holds them in registers, else from Ks, Vs.
template <int D, int BQ, bool KEEP>
__device__ __forceinline__ void score_dots_t_bf16(float (&st)[BQ / 8][4], float (&dpt)[BQ / 8][4],
                                                  const uint32_t (&ka)[KEEP ? D / 16 : 1][4],
                                                  const uint32_t (&va)[KEEP ? D / 16 : 1][4],
                                                  bf16 (*Ks)[D + 8], bf16 (*Vs)[D + 8],
                                                  bf16 (*Qs)[D + 8], bf16 (*dOs)[D + 8], int w0,
                                                  int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4], vf[4];
    if constexpr (KEEP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kf[e] = ka[kk][e];
        vf[e] = va[kk][e];
      }
    } else {
      a_frag<LD>(kf, Ks, w0, kk * 16, lane);
      a_frag<LD>(vf, Vs, w0, kk * 16, lane);
    }
#pragma unroll
    for (int np = 0; np < BQ / 16; ++np) {
      uint32_t b[4];
      bt_frag<LD>(b, Qs, np * 16, kk * 16, lane);
      mma_bf16(st[2 * np], kf, b[0], b[1]);
      mma_bf16(st[2 * np + 1], kf, b[2], b[3]);
      bt_frag<LD>(b, dOs, np * 16, kk * 16, lane);
      mma_bf16(dpt[2 * np], vf, b[0], b[1]);
      mma_bf16(dpt[2 * np + 1], vf, b[2], b[3]);
    }
  }
}

// The bf16 form: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Transposed products keep p and ds in registers: warp w computes s^T = k q^T
// and dp^T = v dout^T for its 16 keys (16 w..) against the BQ queries of the
// tile, so p^T and ds^T come out in the accumulator layout (a thread owns
// keys g and g + 8, queries 2t and 2t + 1 of each 8-query tile, lane = 4 g +
// t), which is the A operand layout of dv += p^T dout and dk += ds^T q; p and
// ds are rounded to bf16 there, as the JAX kernels do.  The warp's k and v
// rows stay in registers as A fragments up to D = 64; at D = 128 they are
// read from shared memory at each use.  With DQ, ds^T also goes to shared
// memory, where the warps read it back transposed as the A operand of the
// dq partial ds k: BQ / 16 blocks of 16 query rows, each split over
// 4 / (BQ / 16) warps by columns of D.  WIDE: the block's slab of D columns
// (blockIdx.z) of rows a.ld long, as in bwd_f32_body.
template <int D, bool DQ, bool WIDE = false>
__device__ __forceinline__ void bwd_bf16_body(const BwdArgs& a) {
  constexpr int LD = D + 8, BQ = bwd_bf16_bq<D>(), LDS = BQ + 8;
  constexpr bool KEEP = D <= 64 && !WIDE;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16 (*Ks)[LD] = reinterpret_cast<bf16 (*)[LD]>(flash_smem);
  bf16 (*Vs)[LD] = Ks + BK;
  bf16 (*Qs)[LD] = Vs + BK;
  bf16 (*dOs)[LD] = Qs + BQ;
  bf16 (*dSTs)[LDS] = reinterpret_cast<bf16 (*)[LDS]>(dOs + BQ);   // ds^T: [key][query]
  float* lse_s = reinterpret_cast<float*>(DQ ? &dSTs[BK][0] : &dSTs[0][0]);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BK;
  const int w0 = warp * 16;                       // this warp's 16 keys
  const int kl[2] = {w0 + g, w0 + g + 8};         // this thread's two keys (in the tile)
  bool key_ok[2];                                 // each below Tk and unmasked
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.tq * ld;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bh * a.tk * ld;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bh * a.tk * ld;
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)bh * a.tq * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  if constexpr (!WIDE) {
    load_rows_bf16<D>(Ks, k, k0, BK, a.tk, tid, H_THREADS);
    load_rows_bf16<D>(Vs, v, k0, BK, a.tk, tid, H_THREADS);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + kl[h];
    key_ok[h] = kg < a.tk && (km == nullptr || km[kg] > 0.f);
  }
  __syncthreads();
  uint32_t ka[KEEP ? D / 16 : 1][4], va[KEEP ? D / 16 : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a_frag<LD>(ka[kk], Ks, w0, kk * 16, lane);
      a_frag<LD>(va[kk], Vs, w0, kk * 16, lane);
    }
  }
  float dk[D / 8][4], dv[D / 8][4];               // keys kl[0], kl[1]; columns of D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (a.tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float* part =
        DQ ? a.dq_part + (((size_t)kt * a.bh + bh) * a.tq_pad + q0) * ld + col0 : nullptr;
    if (skipped(a, q0, BQ, k0)) {
      if constexpr (DQ && WIDE) {
        zero_part<D, BQ>(part, ld, tid, H_THREADS);
      } else if constexpr (DQ) {
        for (int idx = tid; idx < BQ * D / 4; idx += H_THREADS)
          reinterpret_cast<float4*>(part)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    __syncthreads();                 // the last tile's readers are done
    if constexpr (!WIDE) {
      load_rows_bf16<D>(Qs, q, q0, BQ, a.tq, tid, H_THREADS);
      load_rows_bf16<D>(dOs, dout, q0, BQ, a.tq, tid, H_THREADS);
    }
    if (tid < BQ) {
      const bool real = q0 + tid < a.tq;
      lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
      delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
    }

    // s^T = k q^T and dp^T = v dout^T: query rows read as column-major q^T, dout^T
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_bf16<D>(Ks, k + c, k0, BK, a.tk, tid, H_THREADS, ld);
        load_rows_bf16<D>(Vs, v + c, k0, BK, a.tk, tid, H_THREADS, ld);
        load_rows_bf16<D>(Qs, q + c, q0, BQ, a.tq, tid, H_THREADS, ld);
        load_rows_bf16<D>(dOs, dout + c, q0, BQ, a.tq, tid, H_THREADS, ld);
        __syncthreads();
        score_dots_t_bf16<D, BQ, KEEP>(st, dpt, ka, va, Ks, Vs, Qs, dOs, w0, lane);
      }
      if (col0 + D != ld) {          // the products take the block's own slab
        __syncthreads();
        load_rows_bf16<D>(Qs, q + col0, q0, BQ, a.tq, tid, H_THREADS, ld);
        load_rows_bf16<D>(dOs, dout + col0, q0, BQ, a.tq, tid, H_THREADS, ld);
        if constexpr (DQ) load_rows_bf16<D>(Ks, k + col0, k0, BK, a.tk, tid, H_THREADS, ld);
        __syncthreads();
      }
    } else {
      __syncthreads();
      score_dots_t_bf16<D, BQ, KEEP>(st, dpt, ka, va, Ks, Vs, Qs, dOs, w0, lane);
    }

    // p^T and ds^T in place: st[n][e] is key kl[e >> 1], query n*8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const float2 pd = p_ds(st[n][e], dpt[n][e], lse_s[ql], delta_s[ql],
                               key_ok[e >> 1] && causal_ok(a, q0 + ql, k0 + kl[e >> 1]), a.scale);
        st[n][e] = pd.x;
        dpt[n][e] = pd.y;
      }
    if constexpr (DQ) {
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        *reinterpret_cast<uint32_t*>(&dSTs[kl[0]][n * 8 + 2 * t]) = pack_bf16(dpt[n][0], dpt[n][1]);
        *reinterpret_cast<uint32_t*>(&dSTs[kl[1]][n * 8 + 2 * t]) = pack_bf16(dpt[n][2], dpt[n][3]);
      }
    }

    // dv += p^T dout, dk += ds^T q, p and ds rounded to bf16; dout and q rows
    // read transposed as the B operand
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        b_frag<LD>(b, dOs, kk * 16, dp * 16, lane);
        mma_bf16(dv[2 * dp], pa, b[0], b[1]);
        mma_bf16(dv[2 * dp + 1], pa, b[2], b[3]);
        b_frag<LD>(b, Qs, kk * 16, dp * 16, lane);
        mma_bf16(dk[2 * dp], sa, b[0], b[1]);
        mma_bf16(dk[2 * dp + 1], sa, b[2], b[3]);
      }
    }

    if constexpr (DQ) {
      __syncthreads();               // every warp's keys of ds^T are written
      // dq partial = ds k: this warp's 16 query rows (r0..) and DW columns
      // (c0..), in WIDE in two halves of DH columns, which keeps the slab
      // loop's 64-row tile within 255 registers; ds^T read transposed as the
      // A operand, k rows as B
      constexpr int RB = BQ / 16, DW = D / (4 / RB), HALVES = WIDE ? 2 : 1, DH = DW / HALVES;
      const int r0 = (warp % RB) * 16;
#pragma unroll 1
      for (int hf = 0; hf < HALVES; ++hf) {
        const int c0 = (warp / RB) * DW + hf * DH;
        float dq[DH / 8][4];
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t sa[4];
          ldsm_x4_t(sa,
                    &dSTs[kk * 16 + (lane & 7) + (lane >> 4) * 8][r0 + ((lane >> 3) & 1) * 8]);
#pragma unroll
          for (int dp = 0; dp < DH / 16; ++dp) {
            uint32_t b[4];
            b_frag<LD>(b, Ks, kk * 16, c0 + dp * 16, lane);
            mma_bf16(dq[2 * dp], sa, b[0], b[1]);
            mma_bf16(dq[2 * dp + 1], sa, b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          *reinterpret_cast<float2*>(part + (r0 + g) * ld + c0 + n * 8 + 2 * t) =
              make_float2(dq[n][0], dq[n][1]);
          *reinterpret_cast<float2*>(part + (r0 + g + 8) * ld + c0 + n * 8 + 2 * t) =
              make_float2(dq[n][2], dq[n][3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + kl[h];
    if (kg >= a.tk) continue;
    const size_t row = ((size_t)bh * a.tk + kg) * ld + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(a.dk + row + n * 8 + 2 * t) =
          make_float2(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<float2*>(a.dv + row + n * 8 + 2 * t) =
          make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// Whether head dim d runs in the WIDE form of the templates: past 128, a
// multiple of 128 (the wrapper pads it so), one block per slab (grid z).
inline bool wide_head_dim(int d) { return d > 128 && d % 128 == 0; }

// Raise the kernel's dynamic shared memory to what it needs, launch, and
// return the launch's error.
template <typename Args>
int launch_kernel(void (*kernel)(Args), dim3 grid, int threads, size_t smem, cudaStream_t s,
                  const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* kmask,
                 const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                 void* dv, void* dq_part, int bh, int heads, int tq, int tk, int q_offset,
                 int k_offset, int causal, int d, float scale) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = static_cast<const float*>(kmask);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.bh = bh;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.tq_pad = (tq + 63) / 64 * 64;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.ld = d;
  a.scale = scale;
  return a;
}

}  // namespace
