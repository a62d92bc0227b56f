// Flash attention merged backward for Hopper (sm_90a).  For q [BH, Tq, 64],
// k, v [BH, Tk, 64], the cotangent dout [BH, Tq, 64] of the normalized
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
// What bounds it on the H100: 10 * Tq * Tk * 64 operations per head (five
// products of the tile) against (3 Tq + 2 Tk) * 64 elements read and
// (Tq + 2 Tk) * 64 written, so at sequence 4096 it is bound by operations:
// in f32 by the CUDA cores (67 TFLOP/s, no TF32), in bf16 by the tensor
// cores.
//
// What the design does about it: one pass recomputes the score tile from
// lse, never storing p.  As in the TPU kernel, one program owns a 64-key
// tile of one (batch, head) and walks the query tiles, carrying dk and dv
// on chip (the TPU's VMEM scratch; registers here), and writes one dq
// partial per (key tile, query tile).  On the TPU those partials are bf16
// for bf16 inputs and summed outside; here blocks run in parallel and in no
// order, so each block writes f32 partials to its own slice of a
// [Tk/64, BH, Tq', 64] scratch and a second kernel sums them in key-tile
// order: deterministic, no atomics.  Query tiles wholly before a causal
// key tile are skipped and write zero partials, as the JAX kernel does.
//   * f32: 256 threads; each owns 4 x 4 entries (rows ty + 16 i, columns
//     tx + 16 j) of the score tile, then of dk and dv, then of the dq
//     partial, FMA in f32 on the CUDA cores from 65-float padded rows.
//   * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate); warp w
//     owns keys 16w.. of s^T, dp^T, dk and dv, all in registers, and query
//     rows 16w.. of the dq partial, whose ds operand comes from a bf16
//     copy of ds^T in shared memory.
// A simple kernel: no cp.async/TMA pipelining and no wgmma yet.
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 64,
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask, a partial
// scratch of [ceil(Tk/64), BH, ceil(Tq/64)*64, 64] f32.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per block

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [B, Tk] or null
  const void* dout;     // [BH, Tq, D], the inputs' dtype
  const float* lse;     // [BH, Tq]
  const float* delta;   // [BH, Tq]
  float* dk;            // [BH, Tk, D]
  float* dv;            // [BH, Tk, D]
  float* dq_part;       // [n_kt, BH, tq_pad, D]
  int bh, heads, tq, tk, tq_pad, q_offset, k_offset, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, const float* km, int qg, int kg) {
  if (kg >= a.tk) return false;
  if (km != nullptr && !(km[kg] > 0.f)) return false;
  if (a.causal && a.q_offset + qg < a.k_offset + kg) return false;
  return true;
}

// Under causal, a query tile whose last row comes before the key tile's
// first key sees none of it.
__device__ __forceinline__ bool skipped(const BwdArgs& a, int q0, int k0) {
  return a.causal && a.q_offset + min(q0 + BQ, a.tq) - 1 < a.k_offset + k0;
}

// this block's 64 x 64 dq partial for the query tile at q0
__device__ __forceinline__ float* partial_tile(const BwdArgs& a, int kt, int bh, int q0) {
  return a.dq_part + (((size_t)kt * a.bh + bh) * a.tq_pad + q0) * D;
}

__device__ __forceinline__ void zero_tile(float* dst, int tid, int threads) {
  for (int idx = tid; idx < BQ * D / 4; idx += threads)
    reinterpret_cast<float4*>(dst)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ------------------------------------------------------------------ f32
constexpr int LDF = D + 1;
constexpr int F_THREADS = 256;
constexpr size_t F_SMEM = (size_t)6 * 64 * LDF * sizeof(float) + 2 * BQ * sizeof(float);

__device__ __forceinline__ void load_rows_f32(float (*dst)[LDF], const float* src, int row0,
                                              int n_rows, int tid) {
  for (int idx = tid; idx < 64 * (D / 4); idx += F_THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    dst[r][c] = v.x;
    dst[r][c + 1] = v.y;
    dst[r][c + 2] = v.z;
    dst[r][c + 3] = v.w;
  }
}

__global__ void __launch_bounds__(F_THREADS)
fa_bwd_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float (*Ks)[LDF] = reinterpret_cast<float (*)[LDF]>(smem_f32);
  float (*Vs)[LDF] = Ks + 64;
  float (*Qs)[LDF] = Vs + 64;
  float (*dOs)[LDF] = Qs + 64;
  float (*Ps)[LDF] = dOs + 64;
  float (*dSs)[LDF] = Ps + 64;
  float* lse_s = &dSs[64][0];
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BK;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.tq * D;
  const float* k = static_cast<const float*>(a.k) + (size_t)bh * a.tk * D;
  const float* v = static_cast<const float*>(a.v) + (size_t)bh * a.tk * D;
  const float* dout = static_cast<const float*>(a.dout) + (size_t)bh * a.tq * D;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  load_rows_f32(Ks, k, k0, a.tk, tid);
  load_rows_f32(Vs, v, k0, a.tk, tid);

  float dk[4][4], dv[4][4];     // key rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_qt = (a.tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float* part = partial_tile(a, kt, bh, q0);
    if (skipped(a, q0, k0)) {
      zero_tile(part, tid, F_THREADS);
      continue;
    }
    __syncthreads();                 // the last tile's readers are done
    load_rows_f32(Qs, q, q0, a.tq, tid);
    load_rows_f32(dOs, dout, q0, a.tq, tid);
    if (tid < BQ) {
      const bool real = q0 + tid < a.tq;
      lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
      delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s and dp for query rows ty + 16 i, key columns tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse = lse_s[r], dl = delta_s[r];
      const bool alive = lse > NEG_INF * 0.5f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (alive && visible(a, km, q0 + r, k0 + c))
                            ? expf(s[i][j] * a.scale - lse) : 0.f;
        Ps[r][c] = p;
        dSs[r][c] = p * (dp[i][j] - dl) * a.scale;
      }
    }
    __syncthreads();                 // p and ds complete

    // dv += p^T dout, dk += ds^T q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pa[4], sa[4], ob[4], qb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[r][ty + 16 * i];
        sa[i] = dSs[r][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ob[j] = dOs[r][tx + 16 * j];
        qb[j] = Qs[r][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
    // dq partial = ds k: query rows ty + 16 i, columns tx + 16 j
    float dq[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(ty + 16 * i) * D + tx + 16 * j] = dq[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty + 16 * i;
    if (kg >= a.tk) continue;
    const size_t row = ((size_t)bh * a.tk + kg) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.dk[row + tx + 16 * j] = dk[i][j];
      a.dv[row + tx + 16 * j] = dv[i][j];
    }
  }
}

// ----------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
constexpr int LDH = D + 8;   // 144-byte rows: the 8 rows of an ldmatrix hit distinct banks
constexpr int H_THREADS = 128;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void load_rows_bf16(bf16 (*dst)[LDH], const bf16* src, int row0,
                                               int n_rows, int tid) {
  for (int idx = tid; idx < 64 * (D / 8); idx += H_THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// Transposed products keep p and ds in registers: each warp computes
// s^T = k q^T and dp^T = v dout^T for its 16 keys against the 64 queries
// of the tile, so p^T and ds^T come out in the accumulator layout of
// mma.m16n8k16 (a thread owns keys g and g + 8, queries 2t and 2t + 1 of
// each 8-query tile, lane = 4 g + t), which is the A operand layout of
// dv += p^T dout and dk += ds^T q.  ds^T also goes to shared memory
// (bf16), where every warp reads it back transposed (ldmatrix.trans) as
// the A operand of its 16 query rows of the dq partial ds k.
__global__ void __launch_bounds__(H_THREADS)
fa_bwd_bf16_kernel(BwdArgs a) {
  __shared__ __align__(128) bf16 Ks[BK][LDH];
  __shared__ __align__(128) bf16 Vs[BK][LDH];
  __shared__ __align__(128) bf16 Qs[BQ][LDH];
  __shared__ __align__(128) bf16 dOs[BQ][LDH];
  __shared__ __align__(128) bf16 dSTs[BK][LDH];   // ds^T: [key][query]
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BK;
  const int w0 = warp * 16;                       // this warp's 16 keys, and 16 query rows of dq
  const int kl[2] = {w0 + g, w0 + g + 8};         // this thread's two keys (in the tile)
  bool key_ok[2];                                 // each below Tk and unmasked
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.tq * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bh * a.tk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bh * a.tk * D;
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)bh * a.tq * D;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  load_rows_bf16(Ks, k, k0, a.tk, tid);
  load_rows_bf16(Vs, v, k0, a.tk, tid);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + kl[h];
    key_ok[h] = kg < a.tk && (km == nullptr || km[kg] > 0.f);
  }
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];          // this warp's k and v rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldsm_x4(ka[kk], &Ks[w0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
    ldsm_x4(va[kk], &Vs[w0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
  }
  float dk[D / 8][4], dv[D / 8][4];               // keys kl[0], kl[1]; columns of D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (a.tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float* part = partial_tile(a, kt, bh, q0);
    if (skipped(a, q0, k0)) {
      zero_tile(part, tid, H_THREADS);
      continue;
    }
    __syncthreads();                 // the last tile's readers are done
    load_rows_bf16(Qs, q, q0, a.tq, tid);
    load_rows_bf16(dOs, dout, q0, a.tq, tid);
    if (tid < BQ) {
      const bool real = q0 + tid < a.tq;
      lse_s[tid] = real ? a.lse[(size_t)bh * a.tq + q0 + tid] : NEG_INF;
      delta_s[tid] = real ? a.delta[(size_t)bh * a.tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dout^T: query rows read as column-major q^T, dout^T
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4(b, &Qs[row][col]);
        mma_bf16(st[2 * np], ka[kk], b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka[kk], b[2], b[3]);
        ldsm_x4(b, &dOs[row][col]);
        mma_bf16(dpt[2 * np], va[kk], b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va[kk], b[2], b[3]);
      }

    // p^T and ds^T in place: st[n][e] is key kl[e >> 1], query n*8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1);
        const float lse = lse_s[ql];
        const bool seen = key_ok[e >> 1] &&
                          !(a.causal && a.q_offset + q0 + ql < a.k_offset + k0 + kl[e >> 1]);
        const float p = (lse > NEG_INF * 0.5f && seen) ? expf(st[n][e] * a.scale - lse) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - delta_s[ql]) * a.scale;
      }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&dSTs[kl[0]][n * 8 + 2 * t]) = pack_bf16(dpt[n][0], dpt[n][1]);
      *reinterpret_cast<uint32_t*>(&dSTs[kl[1]][n * 8 + 2 * t]) = pack_bf16(dpt[n][2], dpt[n][3]);
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
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, &dOs[row][col]);
        mma_bf16(dv[2 * dp], pa, b[0], b[1]);
        mma_bf16(dv[2 * dp + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, &Qs[row][col]);
        mma_bf16(dk[2 * dp], sa, b[0], b[1]);
        mma_bf16(dk[2 * dp + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();                 // every warp's keys of ds^T are written

    // dq partial = ds k for query rows w0..w0+15: ds^T read transposed as the
    // A operand, k rows transposed as the B operand
    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      ldsm_x4_t(sa, &dSTs[kk * 16 + (lane & 7) + (lane >> 4) * 8][w0 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, &Ks[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
        mma_bf16(dq[2 * dp], sa, b[0], b[1]);
        mma_bf16(dq[2 * dp + 1], sa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(part + (w0 + g) * D + n * 8 + 2 * t) = make_float2(dq[n][0], dq[n][1]);
      *reinterpret_cast<float2*>(part + (w0 + g + 8) * D + n * 8 + 2 * t) =
          make_float2(dq[n][2], dq[n][3]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + kl[h];
    if (kg >= a.tk) continue;
    const size_t row = ((size_t)bh * a.tk + kg) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(a.dk + row + n * 8 + 2 * t) = make_float2(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<float2*>(a.dv + row + n * 8 + 2 * t) = make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ dq reduce
// dq[bh, t, :] = sum over key tiles, in order, of the partials; one float4
// per thread.
__global__ void dq_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dq,
                                 int n_kt, int bh, int tq, int tq_pad) {
  const size_t per_head = (size_t)tq * (D / 4);
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_head * bh) return;
  const size_t head = idx / per_head, rest = idx % per_head;
  const size_t stride = (size_t)bh * tq_pad * (D / 4);
  const float4* src = part + head * tq_pad * (D / 4) + rest;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < n_kt; ++t) {
    const float4 x = src[t * stride];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  dq[idx] = s;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q, const void* k, const void* v,
           const void* kmask, const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, void* dq_part, int bh, int heads, int tq, int tk, int q_offset,
           int k_offset, int causal, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = static_cast<const float*>(kmask);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.bh = bh;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.tq_pad = (tq + BQ - 1) / BQ * BQ;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  a.causal = causal;
  a.scale = scale;
  const int n_kt = (tk + BK - 1) / BK;
  kernel<<<dim3(n_kt, bh), threads, smem, s>>>(a);
  const size_t n4 = (size_t)bh * tq * (D / 4);
  dq_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(dq_part), static_cast<float4*>(dq), n_kt, bh, tq, a.tq_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, void* dq_part, int bh, int heads, int tq, int tk,
                            int q_offset, int k_offset, int causal, float scale, void* stream) {
  return launch(fa_bwd_f32_kernel, F_THREADS, F_SMEM, q, k, v, kmask, dout, lse, delta, dq, dk,
                dv, dq_part, bh, heads, tq, tk, q_offset, k_offset, causal, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             const void* dout, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, void* dq_part, int bh, int heads, int tq, int tk,
                             int q_offset, int k_offset, int causal, float scale, void* stream) {
  return launch(fa_bwd_bf16_kernel, H_THREADS, 0, q, k, v, kmask, dout, lse, delta, dq, dk,
                dv, dq_part, bh, heads, tq, tk, q_offset, k_offset, causal, scale, stream);
}

}  // extern "C"
