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
// (Tq + 2 Tk) * D written, so at sequence 4096 it is bound by operations,
// on the tensor cores: in f32 three TF32 passes a product (165 TFLOP/s of
// f32-accurate work, flash_attention_sm90.cuh; the CUDA cores' FMA peak is
// 67), in bf16 989 TFLOP/s.
//
// What the design does about it: one pass recomputes the score tile from
// lse, never storing p.  As in the TPU kernel, a block owns a key tile of
// one (batch, head) and walks the query tiles, carrying dk and dv on chip
// (the TPU's VMEM scratch; registers here).  On the TPU the dq partials of
// the key tiles are summed outside the kernel; here every key tile adds
// its ds k of a query tile into dq itself, by the TMA's reduce-add, in
// key-tile order behind one flag per (head, slab, query tile), the adds
// issued by a writer warp while the consumers go on
// (flash_attention.cuh, the ordered sum): dq comes out the same on every
// run, and the only scratch beside dq is the flags, 4 (1 + BH Tq/64) bytes
// a slab.  Query tiles wholly before a causal key tile are skipped, as in
// the JAX kernel.
//
//   * bf16: the key-tile body of flash_attention_sm90.cuh on Hopper's
//     tensor-core path: 128 keys per block, one per consumer warpgroup's
//     wgmma M; q, dout, lse and delta stream in by TMA through a ring
//     while the consumers multiply; s^T and dp^T come out of wgmma in the
//     layout of the A operand that dv += p^T dout and dk += ds^T q take
//     from registers; ds^T goes to shared memory once for dq = ds k.
//   * f32 (bwd_tf32_body, flash_attention_sm90.cuh): 64 keys per block,
//     one consumer warpgroup (the f32 tiles, twice split, fill shared
//     memory), every product in three TF32 passes on wgmma.  TF32 wgmma
//     takes both shared operands K-major, so the products are chosen to need no transposed copy of
//     an input: s^T = k q^T and dp^T = v dout^T (A = k, v read into
//     registers; B = q, dout split in place by the producer warpgroup's
//     prep warps); p^T and ds^T go to shared memory (hi | lo) as the B of
//     dv^T += dout^T p and dk^T += q^T ds, whose A operands are dout and q
//     read transposed; dq = ds k with A = ds read transposed from there and
//     B = k^T (hi | lo), which prep transposes once per block.  dk^T and dv^T
//     take each tile's product in a fresh accumulator, added in f32: the
//     tensor core's adds round toward zero, and chained over every query
//     tile that bias grows with Tq.  Below D = 128 k^T and v stay resident and q
//     and dout come in one stage a query tile; from D = 128 on the block owns
//     a 64-column slab and the scores stream through 32-column chunks (q,
//     dout, k, v), then q and dout at the slab.  f32 D = 32 runs D = 64's
//     kernel: the TMA zero-fills the columns past 32 and their score chunk is
//     skipped (a D = 32 template spilled registers).
//
// Head dims past 128 run in column slabs (flash_attention.cuh): of 64
// columns (key_tile_slab in bf16, where D = 128 also takes two; the f32
// blocks' SL).
//
// Requirements checked by the Python wrapper: f32 or bf16, head dim 32, 64,
// 128 or a larger multiple of 128 (it zero-pads others up to the next),
// contiguous 16-byte aligned tensors, an f32 [B, Tk] key mask, dq and the
// int32 flags [1 + BH * slabs * ceil(Tq/64)] zeroed (slabs: ld / 64 past
// 64).  Every entry point returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for another D, or for tensor maps the CUDA driver
// refuses).

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace {

// The block's tile comes from the ticket flags[0] (the ordered sum).
template <int D, bool CHUNKED>
__global__ void __launch_bounds__(2 * WG_THREADS, 1)
fa_bwd_f32_kernel(const __grid_constant__ TmaArgs p) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.a.flags, 1);
  __syncthreads();
  const KeyTileIdx i = key_tile_of(p.a, ticket);
  bwd_tf32_body<D, CHUNKED, true>(p, i.kt, i.bh, i.z);
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
  TmaArgs p;
  if constexpr (BF16) {
    a.slabs = a.ld / key_tile_slab<D, WIDE>();
    const int rc = tma_args(p, a, true);
    if (rc != 0) return rc;
    const dim3 grid(((a.tk + KeyTileSmem<D, true, WIDE>::KB - 1) /
                     KeyTileSmem<D, true, WIDE>::KB) * a.bh * a.slabs);
    return launch_kernel(fa_bwd_bf16_kernel<D, WIDE>, grid, SM90_THREADS,
                         KeyTileSmem<D, true, WIDE>::BYTES, s, p);
  } else {
    // D = 128, and past it in slabs of 64 columns: one template
    constexpr bool CHUNKED = D == 128;
    using L = BwdF32Smem<D, CHUNKED>;
    a.slabs = a.ld > L::SL ? a.ld / L::SL : 1;
    p.a = a;
    if (!(encode_f32_map(&p.q, a.q, a.bh, a.tq, a.ld) && encode_f32_map(&p.k, a.k, a.bh, a.tk, a.ld) &&
          encode_f32_map(&p.v, a.v, a.bh, a.tk, a.ld) &&
          encode_f32_map(&p.dout, a.dout, a.bh, a.tq, a.ld) &&
          encode_f32_map(&p.dq, a.dq, a.bh, a.tq, a.ld)))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(((a.tk + L::KB - 1) / L::KB) * a.bh * a.slabs);
    return launch_kernel(fa_bwd_f32_kernel<D, CHUNKED>, grid, 2 * WG_THREADS, L::BYTES, s, p);
  }
}

template <bool BF16>
int dispatch(int d, const BwdArgs& a, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<BF16 ? 32 : 64, BF16>(a, s);   // f32: D = 64's kernel
    case 64: return launch<64, BF16>(a, s);
    case 128: return launch<128, BF16>(a, s);
  }
  // past 128 in column slabs: of 64 in bf16 (key_tile_slab) and f32
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
