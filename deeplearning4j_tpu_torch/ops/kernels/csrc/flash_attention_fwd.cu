// Flash attention forward for Hopper (sm_90a).  For q [BH, Tq, 64] and
// k, v [BH, Tk, 64] (contiguous, heads flattened into BH = B*H), with
// s = q.k * scale over the visible keys of each row:
//
//     o[BH,Tq,64] = sum_k exp(s - m) v     m[BH,Tq] = max_k s
//     l[BH,Tq]    = sum_k exp(s - m)       (all f32; unnormalized)
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
// What bounds it on the H100: 4 * Tq * Tk * 64 operations per head
// against (Tq + 2 Tk) * 64 elements read, so at sequence 4096 it is bound
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
//     columns tx + 16 j, conflict-free on the 65-float padded rows) of the
//     score tile and of the output, FMA in f32 on the CUDA cores.  The row
//     max and sum are reduced over the 16 lanes that share a row; p goes
//     through shared memory to the p.v product.
//   * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, f32 accumulate), each
//     owning 16 query rows.  Scores, p and the output stay in registers:
//     the accumulator layout of q.k^T is the operand layout of p.v, so p
//     is rounded to bf16 (as the JAX kernel does) and fed back directly.
// A simple kernel: no cp.async/TMA pipelining and no wgmma yet.
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 64,
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile

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
  float scale;
};

__device__ __forceinline__ bool visible(const FwdArgs& a, const float* km, int qg, int kg) {
  if (kg >= a.tk) return false;
  if (km != nullptr && !(km[kg] > 0.f)) return false;
  if (a.causal && a.q_offset + qg < a.k_offset + kg) return false;
  return true;
}

// Number of key tiles a query tile ending at row q_last has to visit: all
// of them, or under causal those up to the last key position q_last sees.
__device__ __forceinline__ int key_tiles(const FwdArgs& a, int q_last) {
  int n = (a.tk + BK - 1) / BK;
  if (a.causal) {
    const long long last = (long long)a.q_offset + q_last - a.k_offset;
    if (last < 0) return 0;
    n = min(n, (int)(last / BK) + 1);
  }
  return n;
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : NEG_INF;
}

// ------------------------------------------------------------------ f32
constexpr int LDF = D + 1;   // padded f32 row: column reads by 16 rows hit 16 banks
constexpr int F_THREADS = 256;

// rows [row0, row0 + 64) of a [n_rows, 64] f32 matrix into dst[64][LDF]; zeros past n_rows
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

__global__ void __launch_bounds__(F_THREADS)
fa_fwd_f32_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float (*Qs)[LDF] = reinterpret_cast<float (*)[LDF]>(smem_f32);
  float (*Ks)[LDF] = Qs + BQ;
  float (*Vs)[LDF] = Ks + BK;
  float (*Ps)[LDF] = Vs + BK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.tq * D;
  const float* k = static_cast<const float*>(a.k) + (size_t)bh * a.tk * D;
  const float* v = static_cast<const float*>(a.v) + (size_t)bh * a.tk * D;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  load_rows_f32(Qs, q, q0, a.tq, tid);

  float acc[4][4], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = key_tiles(a, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    load_rows_f32(Ks, k, k0, a.tk, tid);
    load_rows_f32(Vs, v, k0, a.tk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
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
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                 // the whole p tile is written

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = Vs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg;
    if (a.normalize) {
      float* out = static_cast<float*>(a.out) + row * D;
      const float den = fmaxf(lrow[i], 1e-20f);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[tx + 16 * j] = acc[i][j] / den;
      if (tx == 0) a.lse[row] = lse_of(mrow[i], lrow[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) a.o[row * D + tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        a.m[row] = mrow[i];
        a.l[row] = lrow[i];
      }
    }
  }
}

// ----------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
constexpr int LDH = D + 8;   // 144-byte rows: the 8 rows of an ldmatrix hit distinct banks
constexpr int H_THREADS = 128;

// the 16-bit shared-memory matrix ops and the bf16 tensor-core product
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

// rows [row0, row0 + 64) of a [n_rows, 64] bf16 matrix into dst[64][LDH]; zeros past n_rows
__device__ __forceinline__ void load_rows_bf16(bf16 (*dst)[LDH], const bf16* src, int row0,
                                               int n_rows, int tid) {
  for (int idx = tid; idx < 64 * (D / 8); idx += H_THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

// Fragment layout of mma.m16n8k16 (lane = 4 * g + t): an accumulator holds
// rows g and g + 8, columns 2t and 2t + 1 of its 16x8 tile; so a thread owns
// two query rows, and p's accumulators become the A operand of p.v in
// registers.  K rows are loaded as the column-major k^T (ldmatrix), V rows
// transposed (ldmatrix.trans).
__global__ void __launch_bounds__(H_THREADS)
fa_fwd_bf16_kernel(FwdArgs a) {
  __shared__ __align__(128) bf16 Qs[BQ][LDH];
  __shared__ __align__(128) bf16 Ks[BK][LDH];
  __shared__ __align__(128) bf16 Vs[BK][LDH];
  __shared__ bool key_ok[BK];                     // the tile's keys: below Tk and unmasked

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int m0 = warp * 16;                       // this warp's 16 query rows
  const int qg[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.tq * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bh * a.tk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bh * a.tk * D;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;

  load_rows_bf16(Qs, q, q0, a.tq, tid);
  __syncthreads();
  uint32_t qa[D / 16][4];                         // q rows as A fragments, per 16 of D
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], &Qs[m0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  const int n_kt = key_tiles(a, min(q0 + BQ, a.tq) - 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the last tile's readers are done
    load_rows_bf16(Ks, k, k0, a.tk, tid);
    load_rows_bf16(Vs, v, k0, a.tk, tid);
    if (tid < BK) key_ok[tid] = k0 + tid < a.tk && (km == nullptr || km[k0 + tid] > 0.f);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, &Ks[np * 16 + (lane & 7) + ((lane >> 4) << 3)][kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
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
        ldsm_x4_t(b, &Vs[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qg[h] >= a.tq) continue;
    const size_t row = (size_t)bh * a.tq + qg[h];
    if (a.normalize) {
      uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + row * D);
      const float den = fmaxf(l_run[h], 1e-20f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        out[(n * 8 + 2 * t) / 2] = pack_bf16(o[n][2 * h] / den, o[n][2 * h + 1] / den);
      if (t == 0) a.lse[row] = lse_of(m_run[h], l_run[h]);
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(a.o + row * D + n * 8 + 2 * t) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (t == 0) {
        a.m[row] = m_run[h];
        a.l[row] = l_run[h];
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q, const void* k, const void* v,
           const void* kmask, void* o, void* m, void* l, void* out, void* lse, int bh, int heads,
           int tq, int tk, int q_offset, int k_offset, int causal, int normalize, float scale,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  a.scale = scale;
  dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_fwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            void* o, void* m, void* l, void* out, void* lse, int bh, int heads,
                            int tq, int tk, int q_offset, int k_offset, int causal,
                            int normalize, float scale, void* stream) {
  return launch(fa_fwd_f32_kernel, F_THREADS, (size_t)(BQ + 3 * BK) * LDF * sizeof(float),
                q, k, v, kmask, o, m, l, out, lse, bh, heads, tq, tk, q_offset, k_offset,
                causal, normalize, scale, stream);
}

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             void* o, void* m, void* l, void* out, void* lse, int bh, int heads,
                             int tq, int tk, int q_offset, int k_offset, int causal,
                             int normalize, float scale, void* stream) {
  return launch(fa_fwd_bf16_kernel, H_THREADS, 0, q, k, v, kmask, o, m, l, out, lse, bh,
                heads, tq, tk, q_offset, k_offset, causal, normalize, scale, stream);
}

}  // extern "C"
