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
// lse, never storing p.  As in the TPU kernel, a block owns a key tile of
// one (batch, head) and walks the query tiles, carrying dk and dv on chip
// (the TPU's VMEM scratch; registers here).  On the TPU the dq partials of
// the key tiles are summed outside the kernel; here every key tile adds
// its ds k of a query tile into dq itself, by the TMA's reduce-add, in
// key-tile order behind one flag per (head, slab, query tile)
// (flash_attention.cuh, the ordered sum): dq comes out the same on every
// run, and the only scratch beside dq is the flags, 4 (1 + BH Tq/64) bytes
// a slab.  Query tiles wholly before a causal key
// tile are skipped, as in the JAX kernel.
//
//   * bf16: the key-tile body of flash_attention_sm90.cuh on Hopper's
//     tensor-core path: 128 keys per block, one per consumer warpgroup's
//     wgmma M; q, dout, lse and delta stream in by TMA through a ring
//     while the consumers multiply; s^T and dp^T come out of wgmma in the
//     layout of the A operand that dv += p^T dout and dk += ds^T q take
//     from registers; ds^T goes to shared memory once for dq = ds k,
//     whose tile a writer warp adds into dq while the consumers go on.
//   * f32: 256 threads over a 64-key tile, FMA on the CUDA cores from
//     padded rows (bwd_f32_body), no TF32; its adds into dq go by TMA too,
//     at D = 128 through a writer warpgroup while the 256 go on.
//
// Head dims past 128 run in column slabs (flash_attention.cuh): of 128
// columns in f32, of 64 in bf16, where D = 128 also takes two 64-column
// slabs (key_tile_slab, flash_attention_sm90.cuh).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask, dq and the
// int32 flags [1 + BH * slabs * ceil(Tq/64)] zeroed (slabs: ld / 64 past
// 64).  Every entry point returns cudaGetLastError() after its launch (cudaErrorInvalidValue for
// another D, or for tensor maps the CUDA driver refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// The block's tile comes from the ticket flags[0] (the ordered sum).  The
// least number of blocks per SM holds ptxas to registers that fit as many
// blocks as shared memory allows: three at D = 32 (left to itself it takes
// more and loses the third block), one elsewhere (at D = 128, left to
// itself it picks 128 registers, and runs slower).
template <int D, bool WIDE>
__global__ void __launch_bounds__(f32_merged_threads<D, WIDE>(), !WIDE && D == 32 ? 3 : 1)
fa_bwd_f32_kernel(const __grid_constant__ TmaArgs p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.a.flags, 1);
  __syncthreads();
  const KeyTileIdx i = key_tile_of(p.a, ticket);
  bwd_f32_body<D, true, WIDE>(p.a, &p.dq, i.kt, i.bh, WIDE ? i.z : 0);   // one slab up to 128
}

template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_bwd_bf16_kernel(const __grid_constant__ TmaArgs p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.a.flags, 1);
  __syncthreads();
  const KeyTileIdx i = key_tile_of(p.a, ticket);
  key_tile_body<D, true, WIDE>(p, i.kt, i.bh, i.z);
}

template <int D, bool BF16, bool WIDE = false>
int launch(const BwdArgs& args, cudaStream_t s) {
  BwdArgs a = args;
  a.slabs = a.ld / (BF16 ? key_tile_slab<D, WIDE>() : D);
  const int keys = BF16 ? KeyTileSmem<D, true, WIDE>::KB : BK;
  const dim3 grid(((a.tk + keys - 1) / keys) * a.bh * a.slabs);
  if constexpr (BF16) {
    TmaArgs p;
    const int rc = tma_args(p, a, true);
    if (rc != 0) return rc;
    return launch_kernel(fa_bwd_bf16_kernel<D, WIDE>, grid, SM90_THREADS,
                         KeyTileSmem<D, true, WIDE>::BYTES, s, p);
  } else {
    // the dq map only: rows of D f32 columns in plain layout, as dq_s holds them
    TmaArgs p;
    p.a = a;
    if (!encode_dq_map(&p.dq, a.dq, a.bh, a.tq, a.ld, D, false))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel(fa_bwd_f32_kernel<D, WIDE>, grid, f32_merged_threads<D, WIDE>(),
                         bwd_f32_smem<D, f32_writer<D, WIDE>()>(), s, p);
  }
}

template <bool BF16>
int dispatch(int d, const BwdArgs& a, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32, BF16>(a, s);
    case 64: return launch<64, BF16>(a, s);
    case 128: return launch<128, BF16>(a, s);
  }
  // past 128 in column slabs: of 64 in bf16 (key_tile_slab), else of 128
  if (wide_head_dim(d)) return launch<BF16 ? 64 : 128, BF16, true>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* kmask,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, void* flags, int bh, int heads, int tq, int tk,
                            int q_offset, int k_offset, int causal, int d, float scale,
                            void* stream) {
  return dispatch<false>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, flags, bh,
                                     heads, tq, tk, q_offset, k_offset, causal, d, scale),
                         stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* kmask,
                             const void* dout, const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, void* flags, int bh, int heads, int tq, int tk,
                             int q_offset, int k_offset, int causal, int d, float scale,
                             void* stream) {
  return dispatch<true>(d, bwd_args(q, k, v, kmask, dout, lse, delta, dq, dk, dv, flags, bh,
                                    heads, tq, tk, q_offset, k_offset, causal, d, scale),
                        stream);
}

}  // extern "C"
