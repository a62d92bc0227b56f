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
// sequence 4096 it is bound by operations: in f32 by the CUDA cores
// (67 TFLOP/s, no TF32), in bf16 by the tensor cores.  This algorithm does
// 14 (s and dp are computed in both kernels): two more products per tile
// than the merged form, and no scratch at all.
//
// What the design does about it:
//   * bf16: Hopper's tensor-core path (flash_attention_sm90.cuh).  The dq
//     kernel's block holds 128 query rows, 64 per consumer warpgroup as the
//     M of its wgmma, with q and dout loaded once by TMA; a producer warp
//     streams the 64-key k and v tiles through a ring of stages behind
//     mbarriers; s = q k^T and dp = dout v^T run as wgmma from shared
//     memory, and ds, rounded in the accumulator registers, is the register
//     A operand of dq += ds k.  The dk/dv kernel is the merged form's
//     key-tile body without dq (flash_attention_sm90.cuh).
//   * f32: 256 threads, FMA on the CUDA cores from padded rows; in the dq
//     kernel each owns 4 x 4 entries of the score tile (query rows
//     ty + 16 i, keys tx + 16 j) and 4 x D/16 of dq; ds goes through shared
//     memory.  The dk/dv kernel is bwd_f32_body (flash_attention.cuh).
// Templated on the head dim D in {32, 64, 128}; head dims past 128 run in
// 128-column slabs (flash_attention.cuh); the bf16 dk/dv kernel writes
// 64-column slabs past D = 64 (key_tile_slab, flash_attention_sm90.cuh).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.  Every entry
// point returns cudaGetLastError() after its launches (cudaErrorInvalidValue
// for another D, or for tensor maps the CUDA driver refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

constexpr int BQ = 64;       // query rows per f32 dq block

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

// ---------------------------------------------------------- dk/dv kernel
template <int D, bool WIDE>
__global__ void __launch_bounds__(F_THREADS)
fa_dkv_f32_kernel(BwdArgs a) {
  bwd_f32_body<D, WIDE>(a, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_dkv_bf16_kernel(const __grid_constant__ TmaArgs p) {
  key_tile_body<D, false, WIDE>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& a, cudaStream_t s) {
  int rc;
  const int slabs = WIDE ? a.ld / D : 1;
  if constexpr (BF16) {
    // past 128 the dk/dv kernel runs the merged body's 64-column slabs
    constexpr int DKV = WIDE ? 64 : D;
    using QL = QTileSmem<D, WIDE, 2>;
    using KL = KeyTileSmem<DKV, false, WIDE>;
    TmaArgs p;
    rc = tma_args(p, a, false);
    const dim3 q_grid((a.tq + QL::QB - 1) / QL::QB, a.bh, slabs),
        k_grid((a.tk + KL::KB - 1) / KL::KB, a.bh, a.ld / key_tile_slab<DKV, WIDE>());
    if (rc == 0)
      rc = launch_kernel(fa_dq_bf16_kernel<D, WIDE>, q_grid, SM90_THREADS, QL::BYTES, s, p);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_bf16_kernel<DKV, WIDE>, k_grid, SM90_THREADS, KL::BYTES, s, p);
  } else {
    const dim3 q_grid((a.tq + BQ - 1) / BQ, a.bh, slabs), k_grid((a.tk + BK - 1) / BK, a.bh, slabs);
    rc = launch_kernel(fa_dq_f32_kernel<D, WIDE>, q_grid, F_THREADS, dq_f32_smem<D>(), s, a);
    if (rc == 0)
      rc = launch_kernel(fa_dkv_f32_kernel<D, WIDE>, k_grid, F_THREADS, bwd_f32_smem<D>(),
                         s, a);
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
