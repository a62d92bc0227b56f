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
//   * dq kernel (fa_dq_*): one block per (64-query tile, batch*head) walks
//     the key tiles, recomputes p and ds, and accumulates dq = ds k in
//     registers in f32 (the TPU kernel's dq_scr), written once.  Key tiles
//     wholly in a causal query tile's future are never visited.  In bf16
//     ds is rounded to bf16 before ds k and p is not, as the JAX kernel does.
//   * dk/dv kernel (fa_dkv_*): one block per (64-key tile, batch*head)
//     walks the query tiles: the merged kernel's body (flash_attention.cuh,
//     bwd_*_body with DQ off), skipping the query tiles wholly before a
//     causal key tile.  In bf16 p and ds are rounded before their products.
//
// What bounds it on the H100: the function needs 10 * Tq * Tk * D
// operations per head (five products, as the merged form) against
// (4 Tq + 4 Tk) * D elements read and (Tq + 2 Tk) * D written, so at
// sequence 4096 it is bound by operations: in f32 by the CUDA cores
// (67 TFLOP/s, no TF32), in bf16 by the tensor cores.  This algorithm does
// 14 (s and dp are computed in both kernels): two more products per tile
// than the merged form, and no dq scratch (the merged one writes
// 4 D BH Tq Tk/64 bytes of partials: 103 GB at (B, H, T, D) =
// (2, 12, 32768, 64), past the card's memory).
//
//   * f32: 256 threads; in the dq kernel each owns 4 x 4 entries of the
//     score tile (query rows ty + 16 i, keys tx + 16 j) and 4 x D/16 of dq,
//     FMA on the CUDA cores from padded rows; ds goes through shared memory.
//   * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate); in the
//     dq kernel warp w owns query rows 16 w..: s = q k^T and dp = dout v^T
//     in registers, whose accumulator layout is the A operand layout of
//     ds k, with k rows read transposed as the B operand.  The warp's q and
//     dout rows stay in registers as A fragments up to D = 64.
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// 128-column slabs (flash_attention.cuh).  A simple kernel: no
// cp.async/TMA pipelining and no wgmma yet.
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launches (cudaErrorInvalidValue
// for another D).

#include "flash_attention.cuh"

namespace {

constexpr int BQ = 64;       // query rows per dq block

// ------------------------------------------------------------------ f32
template <int D>
constexpr size_t dq_f32_smem() {
  return (size_t)(4 * 64 * (D + 1) + 64 * (BK + 1) + 2 * BQ) * sizeof(float);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(F_THREADS)
fa_dq_f32_kernel(BwdArgs a) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  float (*Qs)[LD] = reinterpret_cast<float (*)[LD]>(flash_smem);
  float (*dOs)[LD] = Qs + BQ;
  float (*Ks)[LD] = dOs + BQ;
  float (*Vs)[LD] = Ks + BK;
  float (*dSs)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(Vs + BK);
  float* lse_s = &dSs[BQ][0];
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.tq * ld;
  const float* k = static_cast<const float*>(a.k) + (size_t)bh * a.tk * ld;
  const float* v = static_cast<const float*>(a.v) + (size_t)bh * a.tk * ld;
  const float* dout = static_cast<const float*>(a.dout) + (size_t)bh * a.tq * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  if constexpr (!WIDE) {
    load_rows_f32<D>(Qs, q, q0, BQ, a.tq, tid, F_THREADS);
    load_rows_f32<D>(dOs, dout, q0, BQ, a.tq, tid, F_THREADS);
  }
  if (tid < BQ) {
    const bool real = q0 + tid < a.tq;
    lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
    delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
  }

  float dq[4][NJ];                // query rows ty + 16 i, columns col0 + tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    float p[4][4], ds[4][4];         // query rows ty + 16 i, key columns tx + 16 j
    if constexpr (WIDE) {
      // the scores over every slab, then k at the block's own slab for ds k
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = ds[i][j] = 0.f;
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_f32<D>(Qs, q + c, q0, BQ, a.tq, tid, F_THREADS, ld);
        load_rows_f32<D>(dOs, dout + c, q0, BQ, a.tq, tid, F_THREADS, ld);
        load_rows_f32<D>(Ks, k + c, k0, BK, a.tk, tid, F_THREADS, ld);
        load_rows_f32<D>(Vs, v + c, k0, BK, a.tk, tid, F_THREADS, ld);
        __syncthreads();
        score_dots_f32<D>(Qs, dOs, Ks, Vs, tx, ty, p, ds);
      }
      score_finish_f32(a, km, lse_s, delta_s, q0, k0, tx, ty, p, ds);
      if (col0 + D != ld) {
        __syncthreads();
        load_rows_f32<D>(Ks, k + col0, k0, BK, a.tk, tid, F_THREADS, ld);
      }
    } else {
      load_rows_f32<D>(Ks, k, k0, BK, a.tk, tid, F_THREADS);
      load_rows_f32<D>(Vs, v, k0, BK, a.tk, tid, F_THREADS);
      __syncthreads();
      score_tile_f32<D>(a, km, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, tx, ty, p, ds);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[ty + 16 * i][tx + 16 * j] = ds[i][j];
    __syncthreads();                 // ds complete

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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= a.tq) continue;
    const size_t row = ((size_t)bh * a.tq + qg) * ld + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) a.dq[row + tx + 16 * j] = dq[i][j];
  }
}

// ----------------------------------------------------------------- bf16
template <int D>
constexpr size_t dq_bf16_smem() {
  return (size_t)4 * 64 * (D + 8) * sizeof(bf16) + BK;
}

// s += q k^T and dp += dout v^T over the D columns of the tiles in shared
// memory, k and v rows read as column-major k^T, v^T: this warp's 16 query
// rows (m0..), its q and dout rows from the A fragments qa, oa where KEEP
// holds them in registers, else from Qs, dOs.
template <int D, bool KEEP>
__device__ __forceinline__ void score_dots_bf16(float (&s)[BK / 8][4], float (&dp)[BK / 8][4],
                                                const uint32_t (&qa)[KEEP ? D / 16 : 1][4],
                                                const uint32_t (&oa)[KEEP ? D / 16 : 1][4],
                                                bf16 (*Qs)[D + 8], bf16 (*dOs)[D + 8],
                                                bf16 (*Ks)[D + 8], bf16 (*Vs)[D + 8], int m0,
                                                int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4], of[4];
    if constexpr (KEEP) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qf[e] = qa[kk][e];
        of[e] = oa[kk][e];
      }
    } else {
      a_frag<LD>(qf, Qs, m0, kk * 16, lane);
      a_frag<LD>(of, dOs, m0, kk * 16, lane);
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      bt_frag<LD>(b, Ks, np * 16, kk * 16, lane);
      mma_bf16(s[2 * np], qf, b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf, b[2], b[3]);
      bt_frag<LD>(b, Vs, np * 16, kk * 16, lane);
      mma_bf16(dp[2 * np], of, b[0], b[1]);
      mma_bf16(dp[2 * np + 1], of, b[2], b[3]);
    }
  }
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(H_THREADS)
fa_dq_bf16_kernel(BwdArgs a) {
  constexpr int LD = D + 8;
  constexpr bool KEEP = D <= 64 && !WIDE;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16 (*Qs)[LD] = reinterpret_cast<bf16 (*)[LD]>(flash_smem);
  bf16 (*dOs)[LD] = Qs + BQ;
  bf16 (*Ks)[LD] = dOs + BQ;
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
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)bh * a.tq * ld;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool real = qg[h] < a.tq;
    lse[h] = real ? a.lse[(size_t)bh * a.tq + qg[h]] : NEG_INF;
    delta[h] = real ? a.delta[(size_t)bh * a.tq + qg[h]] : 0.f;
  }
  uint32_t qa[KEEP ? D / 16 : 1][4], oa[KEEP ? D / 16 : 1][4];
  if constexpr (!WIDE) {
    load_rows_bf16<D>(Qs, q, q0, BQ, a.tq, tid, H_THREADS);
    load_rows_bf16<D>(dOs, dout, q0, BQ, a.tq, tid, H_THREADS);
    __syncthreads();
  }
  if constexpr (KEEP) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a_frag<LD>(qa[kk], Qs, m0, kk * 16, lane);
      a_frag<LD>(oa[kk], dOs, m0, kk * 16, lane);
    }
  }

  float dq[D / 8][4];             // rows qg[0], qg[1]; columns col0.. of D
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    // s = q k^T and dp = dout v^T: k and v rows read as column-major k^T, v^T
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (WIDE) {
      // the scores over every slab, then k at the block's own slab for ds k
      for (int c = 0; c < ld; c += D) {
        if (c) __syncthreads();      // the last slab's readers are done
        load_rows_bf16<D>(Qs, q + c, q0, BQ, a.tq, tid, H_THREADS, ld);
        load_rows_bf16<D>(dOs, dout + c, q0, BQ, a.tq, tid, H_THREADS, ld);
        load_rows_bf16<D>(Ks, k + c, k0, BK, a.tk, tid, H_THREADS, ld);
        load_rows_bf16<D>(Vs, v + c, k0, BK, a.tk, tid, H_THREADS, ld);
        if (c == 0 && tid < BK)
          key_ok[tid] = k0 + tid < a.tk && (km == nullptr || km[k0 + tid] > 0.f);
        __syncthreads();
        score_dots_bf16<D, KEEP>(s, dp, qa, oa, Qs, dOs, Ks, Vs, m0, lane);
      }
      if (col0 + D != ld) {
        __syncthreads();
        load_rows_bf16<D>(Ks, k + col0, k0, BK, a.tk, tid, H_THREADS, ld);
        __syncthreads();
      }
    } else {
      load_rows_bf16<D>(Ks, k, k0, BK, a.tk, tid, H_THREADS);
      load_rows_bf16<D>(Vs, v, k0, BK, a.tk, tid, H_THREADS);
      if (tid < BK) key_ok[tid] = k0 + tid < a.tk && (km == nullptr || km[k0 + tid] > 0.f);
      __syncthreads();
      score_dots_bf16<D, KEEP>(s, dp, qa, oa, Qs, dOs, Ks, Vs, m0, lane);
    }

    // ds in place of s: s[n][e] is row qg[e >> 1], key n*8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kl = n * 8 + 2 * t + (e & 1);
        s[n][e] = p_ds(s[n][e], dp[n][e], lse[h], delta[h],
                       key_ok[kl] && causal_ok(a, qg[h], k0 + kl), a.scale).y;
      }

    // dq += ds k, ds rounded to bf16: two 8-key accumulator tiles make one
    // 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp_ = 0; dp_ < D / 16; ++dp_) {
        uint32_t b[4];
        b_frag<LD>(b, Ks, kk * 16, dp_ * 16, lane);
        mma_bf16(dq[2 * dp_], da, b[0], b[1]);
        mma_bf16(dq[2 * dp_ + 1], da, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qg[h] >= a.tq) continue;
    const size_t row = ((size_t)bh * a.tq + qg[h]) * ld + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(a.dq + row + n * 8 + 2 * t) =
          make_float2(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------- dk/dv kernel
template <int D, bool WIDE>
__global__ void __launch_bounds__(F_THREADS)
fa_dkv_f32_kernel(BwdArgs a) {
  bwd_f32_body<D, false, WIDE>(a);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(H_THREADS)
fa_dkv_bf16_kernel(BwdArgs a) {
  bwd_bf16_body<D, false, WIDE>(a);
}

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& a, cudaStream_t s) {
  const int slabs = WIDE ? a.ld / D : 1;
  const dim3 q_grid((a.tq + BQ - 1) / BQ, a.bh, slabs), k_grid((a.tk + BK - 1) / BK, a.bh, slabs);
  int rc;
  if constexpr (BF16) {
    rc = launch_kernel(fa_dq_bf16_kernel<D, WIDE>, q_grid, H_THREADS, dq_bf16_smem<D>(), s, a);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_bf16_kernel<D, WIDE>, k_grid, H_THREADS,
                         bwd_bf16_smem<D, false>(), s, a);
  } else {
    rc = launch_kernel(fa_dq_f32_kernel<D, WIDE>, q_grid, F_THREADS, dq_f32_smem<D>(), s, a);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_f32_kernel<D, WIDE>, k_grid, F_THREADS, bwd_f32_smem<D>(), s,
                         a);
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
  if (wide_head_dim(d)) return launch<128, BF16, true>(a, s);
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
