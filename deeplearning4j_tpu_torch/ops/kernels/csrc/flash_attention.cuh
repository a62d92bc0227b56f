// Device code shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bwd_split.cu): the f32 tile
// loader, mbarriers, the backward's arguments and visibility rule, its
// ordered dq sum, the f32 tensor maps, and the f32 body of the split
// backward's dk/dv kernel (FMA on the CUDA cores).  Every bf16 kernel, and
// the f32 forward and merged backward, are built on Hopper's wgmma and TMA
// (flash_attention_sm90.cuh; f32 in three TF32 passes a product).
//
// Every kernel is templated on the head dim D in {32, 64, 128}; the wrapper
// zero-pads any other head dim up to 128 to the next of these.  A head dim
// past 128 is zero-padded to a multiple of 128 (the row length ld in device
// memory) and runs in the WIDE form of a template: the output columns are
// split into slabs, one slab per block (of 128 columns in the split f32
// kernels and the bf16 forward, of 64 in the bf16 key-tile kernels and the
// f32 forward and merged backward). Each block computes the scores s = q.k
// (and dp = dout.v in the backward) over the whole head dim, always in the
// same order, and accumulates only its own columns of o (forward), or of
// dk, dv and dq (backward). So the accumulators stay those of one slab, s
// and dp are recomputed once per slab, and m, l and lse come out the same in
// every slab (slab 0 writes them). All tiles live in dynamic shared memory
// (the launchers raise the 48 KB default where a template needs more).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;           // keys per tile
constexpr int F_THREADS = 256;   // f32 kernels: 16 x 16 threads over a 64 x 64 tile
constexpr int WG_THREADS = 128;  // a warpgroup
// setmaxnreg: a warpgroup that only moves data gives registers to those that compute
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

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

// ------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The thread's warpgroup, as a value the compiler knows is the same across
// the warp (setmaxnreg needs each branch warpgroup-uniform).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
  float* dq;            // [BH, Tq, D]; zeros on entry to the merged backward
  float* dk;            // [BH, Tk, D]
  float* dv;            // [BH, Tk, D]
  int* flags;           // merged backward: zeros on entry, [1 + BH * slabs * n_qt]
  int bh, heads, tq, tk, q_offset, k_offset, causal;
  int ld;               // the (padded) head dim: every D above is this row length
  int slabs;            // merged backward: column slabs of a head (set by its launcher)
  int n_qt;             // 64-row query tiles of a head
  float scale;
};

// The backward's tensor maps and arguments: one __grid_constant__
// parameter (the maps of q, k, v, dout for the bf16 kernels, of dq for the
// merged kernels' adds).
struct alignas(64) TmaArgs {
  CUtensorMap q, k, v, dout;    // bf16 [BH, T, ld], boxes [1, 64, BX]
  CUtensorMap dq;               // f32 [BH, Tq, ld]
  BwdArgs a;
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

// The merged backward's dq sum.  dq starts at zero and every key tile adds
// its contribution ds k of each query tile into it, in key-tile order: the
// block of key tile kt waits until the flag of (head, slab, query tile) reads
// kt, adds, and sets it to kt + 1.  So every run adds in the same order and
// dq comes out bit for bit the same, with no per-key-tile partials.  The
// key tiles a query tile sees are a prefix 0..n-1 (a causal tile skips the
// query tiles wholly before it, and so does every later key tile), so no
// block waits on a flag that will not move.  flags[0] hands out the blocks'
// tiles in that order (ticket): a block takes its tile when it starts, so
// the tile it waits on belongs to a block that started earlier and runs.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// A wait that has not ended after WAIT_LIMIT_NS traps: a fault in the
// pipeline ends the launch with an error instead of hanging the card.
constexpr unsigned long long WAIT_LIMIT_NS = 20000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void wait_guard(unsigned long long& t0) {
  const unsigned long long now = global_ns();
  if (t0 == 0) {
    t0 = now;
  } else if (now - t0 > WAIT_LIMIT_NS) {
    __trap();
  }
}

// ------------------------------------------------------------ mbarriers
// mbarriers (and the tiles of flash_attention_sm90.cuh) are named by 32-bit
// shared-memory addresses: half the registers of generic pointers.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Expect `bytes` more of TMA traffic in the barrier's phase, without arriving.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t addr, int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    wait_guard(t0);
  }
}

// The ordered sum's wait for flag == value.
__device__ __forceinline__ void flag_wait(const int* flag, int value) {
  unsigned long long t0 = 0;
  while (ld_acquire(flag) != value) wait_guard(t0);
}

__device__ __forceinline__ int* dq_flag(const BwdArgs& a, int bh, int z, int qt) {
  return a.flags + 1 + ((size_t)bh * a.slabs + z) * a.n_qt + qt;
}

// The adds themselves: dq[bh, row.., col..] += a box of f32 in shared
// memory, by the TMA unit (rows past Tq are dropped); a block issues them,
// commits, and later waits until they are done, when it may set the flag
// and reuse the box.
__device__ __forceinline__ void tma_add_box(const CUtensorMap* map, uint32_t src, int col, int row,
                                            int bh) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

__device__ __forceinline__ void tma_adds_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_adds_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");   // before the flag's release
}

// A 3-D map over f32 [BH, rows, ld] (innermost first) in boxes of 64 rows x
// 32 columns, 128-byte swizzled: the merged backward's dq (the adds) and the
// f32 kernels' inputs.  Rows past `rows` read as zeros.
inline bool encode_f32_map(CUtensorMap* map, const void* ptr, int bh, int rows, int ld) {
  cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)rows * ld * 4};
  cuuint32_t boxes[3] = {32, 64, 1};
  cuuint32_t one[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                                dims, strides, boxes, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile of the merged kernel's block: ticket t, key tile slowest.
struct KeyTileIdx {
  int kt, bh, z;
};

__device__ __forceinline__ KeyTileIdx key_tile_of(const BwdArgs& a, int t) {
  return {t / (a.slabs * a.bh), (t / a.slabs) % a.bh, t % a.slabs};
}

// Under causal, a query tile whose last row comes before the key tile's
// first key sees none of it (the JAX kernels' last_q_pos >= first_k_pos).
__device__ __forceinline__ bool skipped(const BwdArgs& a, int q0, int bq, int k0) {
  return a.causal && a.q_offset + min(q0 + bq, a.tq) - 1 < a.k_offset + k0;
}

// Key tiles of bk keys a query tile ending at row q_last visits: all of
// them, or under causal those up to the last key position q_last sees.
__device__ __forceinline__ int key_tiles(int tk, int causal, int q_offset, int k_offset,
                                         int q_last, int bk = BK) {
  int n = (tk + bk - 1) / bk;
  if (causal) {
    const long long last = (long long)q_offset + q_last - k_offset;
    if (last < 0) return 0;
    n = min(n, (int)(last / bk) + 1);
  }
  return n;
}

// The f32 dk/dv kernel's tiles (the split backward's, flash_attention_bwd_split.cu).
template <int D>
__host__ __device__ constexpr size_t bwd_f32_smem() {
  return (size_t)(4 * 64 * (D + 1) + 2 * 64 * (BK + 1) + 2 * 64) * sizeof(float);
}

// The split backward's dk/dv block: a 64-key tile kt of one (batch, head)
// bh (and slab z) walks the 64-row query tiles, carrying dk and dv in
// registers (the TPU kernels' VMEM scratch):
//
//     p  = exp(q.k * scale - lse)   on visible keys of live rows, else 0
//     ds = p * (dout.v - delta) * scale
//     dv += p^T dout,  dk += ds^T q              (f32)
//
// Each of 256 threads owns 4 x 4 entries of the score tile (rows ty + 16 i,
// keys tx + 16 j) and 4 x D/16 of dk and dv, FMA on the CUDA cores from
// padded rows.  WIDE: the block's slab z of D columns of rows a.ld long; the
// score tile sums over every slab (k and v tiles reloaded per slab with q
// and dout), then q and dout are reloaded at the block's own slab for the
// products.
template <int D, bool WIDE = false>
__device__ __forceinline__ void bwd_f32_body(const BwdArgs& a, int kt, int bh, int z) {
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
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, k0 = kt * BK;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? z * D : 0;
  const int n_qt = (a.tq + BQ - 1) / BQ;
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

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    if (skipped(a, q0, BQ, k0)) continue;
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
                 void* dv, void* flags, int bh, int heads, int tq, int tk, int q_offset,
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
  a.flags = static_cast<int*>(flags);
  a.bh = bh;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.ld = d;
  a.slabs = 1;
  a.n_qt = (tq + 63) / 64;
  a.scale = scale;
  return a;
}

}  // namespace
