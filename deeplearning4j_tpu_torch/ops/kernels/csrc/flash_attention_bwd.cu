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
// (Tq + 2 Tk) * D written, so at sequence 4096 it is bound by operations:
// in f32 by the CUDA cores (67 TFLOP/s, no TF32), in bf16 by the tensor
// cores.
//
// What the design does about it: one pass recomputes the score tile from
// lse, never storing p.  As in the TPU kernel, one program owns a 64-key
// tile of one (batch, head) and walks the query tiles, carrying dk and dv
// on chip (the TPU's VMEM scratch; registers here), and writes one dq
// partial per (key tile, query tile): bwd_f32_body / bwd_bf16_body of
// flash_attention.cuh with DQ on.  On the TPU those partials are bf16 for
// bf16 inputs and summed outside; here blocks run in parallel and in no
// order, so each block writes f32 partials to its own slice of a
// [Tk/64, BH, Tq', D] scratch and a second kernel sums them in key-tile
// order: deterministic, no atomics.  Query tiles wholly before a causal
// key tile are skipped and write zero partials, as the JAX kernel does.
// The scratch takes 4 D BH Tq' Tk/64 bytes: quadratic in the sequence
// (flash_attention_bwd_split.cu needs none).
// A simple kernel: no cp.async/TMA pipelining and no wgmma yet.
//
// Head dims past 128 run in column slabs (flash_attention.cuh): of 128
// columns in f32, of 64 in bf16, where the 128-column slab spills.
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask, a partial
// scratch of [ceil(Tk/64), BH, ceil(Tq/64)*64, D] f32.  Every entry point
// returns cudaGetLastError() after its launches (cudaErrorInvalidValue for
// another D).

#include "flash_attention.cuh"

namespace {

template <int D, bool WIDE>
__global__ void __launch_bounds__(F_THREADS)
fa_bwd_f32_kernel(BwdArgs a) {
  bwd_f32_body<D, true, WIDE>(a);
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(H_THREADS)
fa_bwd_bf16_kernel(BwdArgs a) {
  bwd_bf16_body<D, true, WIDE>(a);
}

// dq[bh, t, :] = sum over key tiles, in order, of the partials, rows of d4
// float4; one float4 per thread.
__global__ void dq_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dq,
                                 int n_kt, int bh, int tq, int tq_pad, int d4) {
  const size_t per_head = (size_t)tq * d4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_head * bh) return;
  const size_t head = idx / per_head, rest = idx % per_head;
  const size_t stride = (size_t)bh * tq_pad * d4;
  const float4* src = part + head * tq_pad * d4 + rest;
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

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& a, void* dq, cudaStream_t s) {
  const int n_kt = (a.tk + BK - 1) / BK;
  const dim3 grid(n_kt, a.bh, WIDE ? a.ld / D : 1);
  int rc;
  if constexpr (BF16)
    rc = launch_kernel(fa_bwd_bf16_kernel<D, WIDE>, grid, H_THREADS,
                       bwd_bf16_smem<D, true>(), s, a);
  else
    rc = launch_kernel(fa_bwd_f32_kernel<D, WIDE>, grid, F_THREADS, bwd_f32_smem<D>(), s, a);
  if (rc != 0) return rc;
  const size_t n4 = (size_t)a.bh * a.tq * (a.ld / 4);
  dq_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(a.dq_part), static_cast<float4*>(dq), n_kt, a.bh, a.tq,
      a.tq_pad, a.ld / 4);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch(int d, const BwdArgs& a, void* dq, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32, BF16>(a, dq, s);
    case 64: return launch<64, BF16>(a, dq, s);
    case 128: return launch<128, BF16>(a, dq, s);
  }
  // past 128 in slabs: of 64 columns in bf16, where the 128-column slab's
  // dk, dv and dq-partial state spills past 255 registers, else of 128
  if (wide_head_dim(d)) return launch<BF16 ? 64 : 128, BF16, true>(a, dq, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, void* dq_part, int bh, int heads, int tq, int tk,
                            int q_offset, int k_offset, int causal, int d, float scale,
                            void* stream) {
  return dispatch<false>(d, bwd_args(q, k, v, kmask, dout, lse, delta, nullptr, dk, dv, dq_part,
                                     bh, heads, tq, tk, q_offset, k_offset, causal, d, scale),
                         dq, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             const void* dout, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, void* dq_part, int bh, int heads, int tq,
                             int tk, int q_offset, int k_offset, int causal, int d, float scale,
                             void* stream) {
  return dispatch<true>(d, bwd_args(q, k, v, kmask, dout, lse, delta, nullptr, dk, dv, dq_part,
                                    bh, heads, tq, tk, q_offset, k_offset, causal, d, scale),
                        dq, stream);
}

}  // extern "C"
