// Device code shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bwd_split.cu): mbarriers, the
// backward's arguments and visibility rule, its ordered dq sum and the f32
// tensor maps.  Every kernel is built on Hopper's wgmma and TMA
// (flash_attention_sm90.cuh; f32 in three TF32 passes a product).
//
// Every kernel is templated on the head dim D in {32, 64, 128}; the wrapper
// zero-pads any other head dim up to 128 to the next of these.  A head dim
// past 128 is zero-padded to a multiple of 128 (the row length ld in device
// memory) and runs in the WIDE form of a template: the output columns are
// split into slabs, one slab per block (of 128 columns in the bf16 forward
// and both dq kernels, of 64 in the key-tile kernels and the f32 forward).
// Each block computes the scores s = q.k (and dp = dout.v in the backward)
// over the whole head dim, always in the same order, and accumulates only
// its own columns of o (forward), or of dk, dv and dq (backward). So the
// accumulators stay those of one slab, s and dp are recomputed once per
// slab, and m, l and lse come out the same in every slab (slab 0 writes
// them). All tiles live in dynamic shared memory (the launchers raise the
// 48 KB default where a template needs more).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;           // keys per tile
constexpr int WG_THREADS = 128;  // a warpgroup
// setmaxnreg: a warpgroup that only moves data gives registers to those that compute
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

using bf16 = __nv_bfloat16;

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
