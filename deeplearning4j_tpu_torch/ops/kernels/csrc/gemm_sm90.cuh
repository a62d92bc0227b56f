// The GEMM core of the port's Hopper (sm_90a) kernels that are plain or
// implicit GEMMs with a prologue or an epilogue: conv3x3_bn_act.cu (where it
// was first written), matmul_bn_act.cu, matmul_bn_act_bwd.cu and
// int8_matmul.cu.
//
//   * The block: one producer warpgroup and two consumer warpgroups of 64
//     output rows (CONSUMERS, flash_attention_sm90.cuh; GEMM_THREADS in all).
//     Warp 0 of the producer warpgroup issues the TMA loads; warps 1-3 (the
//     GEMM_PREP prep threads) work on a stage in place where a kernel needs
//     it (a BatchNorm fold, a TF32 split, a transposed copy) between the
//     TMA's full barrier and the consumers' ready barrier.
//   * Ring: ST stages behind full (the TMA), ready (prep) and empty (one
//     arrival per consumer warp) mbarriers.
//   * A goes to wgmma from registers: ldmatrix (bf16, and f32 as pairs of
//     16-bit words, flash_attention_sm90.cuh's a_split_rows), ldmatrix.trans
//     for a transposed A, and int8 bytes widened in registers (i8_f32,
//     i8_bf16x2).  B comes from shared memory through a descriptor.
//   * f32 runs as TF32 passes (the split and mma3 stay in
//     flash_attention_sm90.cuh), each step's product in a fresh tile added to
//     the accumulator in f32 (add_tile): the tensor core's adds round toward
//     zero, and chained over a long contraction that bias would reach the f32
//     limits.
//   * wgmma forms the flash kernels lack: bf16 with A from registers and a
//     K-major B (wgmma_rs_k, N = 8, 16, 32, 128), bf16 with a K-major A and an
//     N-major B both in shared memory (wgmma_ss_kn, N = 128), TF32 at N = 8
//     and 16.
//   * A tile of the output stored from shared memory by the TMA (tma_store).
//   * Split-K in the same launch (splitk_sum): each split writes its f32
//     partial, and the last split of a tile to arrive adds all partials in
//     split order (past a group of splits, in two fixed levels), so the
//     result repeats bit for bit.
//   * Column sums of two quantities over the block's rows (or running sums
//     over several tiles of a persistent block), then over the row tiles of a
//     column block of 64 or 128 (col_sums, col_sums_warp, col_sums_tables):
//     two levels of arrival counts, each level added in a fixed order.
#pragma once

#include "flash_attention_sm90.cuh"

namespace {

constexpr int GEMM_BN = 64;                          // columns of a col_sums block
constexpr int GEMM_PREP = 96;                        // prep threads (a multiple of 8)
constexpr int GEMM_GROUP = 32;                       // row tiles whose column sums are added first
constexpr int GEMM_THREADS = CONSUMERS + WG_THREADS;

// ------------------------------------------------------------ A operands
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The same, each 8 x 8 block of 16-bit words transposed: lane 4 g + t
// receives words (2 t, g) and (2 t + 1, g) of each block, the first in the
// low half.
__device__ __forceinline__ void ldmatrix4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Byte i of u (u: four int8 with their sign bits flipped, v ^ 0x80) as the
// f32 value of the int8: 2^23 + (v + 128) built by one byte permute, less
// 2^23 + 128.  Exact, and a TF32 value (at most 8 significant bits).
__device__ __forceinline__ float i8_f32(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// Two such values as a bf16 pair, lo in the low half: an int8 as f32 has
// no bits in the low 16 of its word, so its high half is its bf16.
__device__ __forceinline__ uint32_t i8_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Wait until at most one committed wgmma group is still in flight.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// f32 to an output of type T (bf16: rounded to nearest)
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The BatchNorm fold of the 1x1 and 3x3 kernels, x a + b then (relu_in)
// relu: no FMA contraction, each step rounded as the plain version rounds it.
__device__ __forceinline__ float pre_act(float v, float a, float b) {
  return __fadd_rn(__fmul_rn(v, a), b);
}

__device__ __forceinline__ float xhat_of(float v, float a, float b, int relu_in) {
  const float h = pre_act(v, a, b);
  return (relu_in && !(h > 0.f)) ? 0.f : h;
}

// a bf16 pair (the first in the low half) as two floats
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int N>
__device__ __forceinline__ void add_tile(float (&acc)[N], const float (&tile)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += tile[i];
}

// The m64n64 tile of column half H of an m64n128 accumulator (its entries
// 32 H ..: columns 64 H + 8 j + 2 t + e at 32 H + 4 j + 2 h + e) added in.
template <int H>
__device__ __forceinline__ void add_half(float (&acc)[64], const float (&tile)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[32 * H + i] += tile[i];
}

// A barrier of the prep threads alone.
__device__ __forceinline__ void prep_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(GEMM_PREP) : "memory");
}

// ----------------------------------------------------------------- ring
// ST stages, unit u in stage u % ST at phase (u / ST) & 1.  full, ready,
// empty: the shared addresses of three arrays of ST mbarriers (ready 0
// where no prep works on the stages).  The stages go back to the producer
// when `releasers` warps have released them (the consumer warps, or the
// prep warps of a ring only prep reads).
template <int ST>
struct Ring {
  uint32_t full, ready, empty;

  __device__ __forceinline__ void init(int prep, int releasers = CONSUMERS / 32) const {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      if (ready) mbar_init(ready + 8 * s, prep);
      mbar_init(empty + 8 * s, releasers);
    }
  }
  // (unsigned: a power-of-two ST is a mask and a shift)
  static __device__ __forceinline__ int stage(int u) { return (unsigned)u % ST; }
  static __device__ __forceinline__ int phase(int u) { return ((unsigned)u / ST) & 1; }
  // producer: wait until unit u's stage is free (its last unit retired)
  __device__ __forceinline__ int acquire(int u) const {
    mbar_wait(empty + 8 * stage(u), phase(u) ^ 1);
    return stage(u);
  }
  __device__ __forceinline__ uint32_t full_bar(int u) const { return full + 8 * stage(u); }
  __device__ __forceinline__ int wait_full(int u) const {
    mbar_wait(full + 8 * stage(u), phase(u));
    return stage(u);
  }
  __device__ __forceinline__ int wait_ready(int u) const {
    mbar_wait(ready + 8 * stage(u), phase(u));
    return stage(u);
  }
  // prep: unit u is ready for the consumers (after a proxy fence where wgmma
  // reads what prep wrote)
  __device__ __forceinline__ void arrive_ready(int u) const { mbar_arrive(ready + 8 * stage(u)); }
  // a releasing warp is done with unit u (its lane 0 arrives for it, after
  // a __syncwarp of the caller's: release)
  __device__ __forceinline__ void arrive_empty(int u) const { mbar_arrive(empty + 8 * stage(u)); }
  __device__ __forceinline__ void release(int u, int lane) const {
    __syncwarp();
    if (lane == 0) arrive_empty(u);
  }
};

// ---------------------------------------------------------------- wgmma
// d (64 x N) += a (64 x 16, bf16 registers) . b (16 x N, K-major, shared memory)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 128) += a (64 x 16, K-major) . b (16 x 128, N-major): both bf16 in
// shared memory (acc 0: d afresh)
__device__ __forceinline__ void wgmma_ss_kn(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N) += a (64 x 8, TF32 registers) . b (8 x N, K-major TF32), N = 8, 16
// (N = 32, 64, 128: flash_attention_sm90.cuh)
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// K-major operand of a 128-byte swizzled tile (rows of 128 bytes, 8-row
// atoms 1024 bytes apart) at base, from byte `col` of its rows on.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t base, int col) {
  return gmma_desc(base + col, 16, 1024, 1);
}

// --------------------------------------------------------------- split-K
// The last of `total` blocks to arrive at the count: true in it (after a
// fence, so that it sees what the others wrote before they arrived).
__device__ __forceinline__ bool last_to_arrive(int* count, int total, int* last) {
  __threadfence();
  consumers_sync(1);
  if (threadIdx.x == 0) *last = atomicAdd(count, 1) == total - 1;
  consumers_sync(1);
  if (!*last) return false;
  __threadfence();
  return true;
}

// acc = the sum of slices [s0, s1) of part, from zero, in slice order
// (entries idx(i) < 0 left as they are): W = 1 entry by entry, the fewest
// registers; else one slice's loads of up to W entries in flight at a time.
template <int W, typename P, int N, class Idx>
__device__ __forceinline__ void sum_slices(P (&acc)[N], const P* part, size_t slice, int s0,
                                           int s1, Idx idx) {
  if constexpr (W == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const long long o = idx(i);
      if (o < 0) continue;
      P sum = P(0);
      for (int s = s0; s < s1; ++s) sum += __ldcg(part + (size_t)s * slice + o);
      acc[i] = sum;
    }
  } else {
    constexpr int B = N < W ? N : W;
#pragma unroll
    for (int i0 = 0; i0 < N; i0 += B) {
#pragma unroll
      for (int i = i0; i < i0 + B; ++i) acc[i] = P(0);
      for (int s = s0; s < s1; ++s) {
        P v[B];
#pragma unroll
        for (int i = 0; i < B; ++i) {
          const long long o = idx(i0 + i);
          v[i] = o >= 0 ? __ldcg(part + (size_t)s * slice + o) : P(0);
        }
#pragma unroll
        for (int i = 0; i < B; ++i) acc[i0 + i] += v[i];
      }
    }
  }
}

// Split-K in one launch: each of a tile's `splits` blocks writes its
// partial (f32, or f64 where a kernel keeps its sum so; entry i of acc at
// offset idx(i) of a slice, or nowhere where idx(i) < 0) to slice z of
// part; the last of them to arrive adds the partials in split order into
// acc, so the sum repeats bit for bit.  Past GROUP splits (GROUP 0: one
// level always) the adds take two levels, each in a fixed order: the last
// block of each group of GROUP consecutive splits adds the group's partials
// into slice splits + its group, and the last group the groups' sums.
// part: [splits (+ groups when there are more than one), slice]; count: the
// tile's arrival counts, zeros before the launch ([groups + 1] when there
// are more groups than one, else [1]).  Returns false in the blocks whose
// work is then done.  Consumer threads only; `last` is a shared int.  W:
// sum_slices's width.
template <int W, int GROUP, typename P, int N, class Idx>
__device__ __forceinline__ bool splitk_sum(P (&acc)[N], P* part, size_t slice, int z, int splits,
                                           int* count, int* last, Idx idx) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long o = idx(i);
    if (o >= 0) part[(size_t)z * slice + o] = acc[i];
  }
  const int n_groups = GROUP ? (splits + GROUP - 1) / GROUP : 1;
  if (n_groups == 1) {
    if (!last_to_arrive(count, splits, last)) return false;
    sum_slices<W>(acc, part, slice, 0, splits, idx);
    return true;
  }
  const int grp = z / GROUP, g0 = grp * GROUP, g1 = min(g0 + GROUP, splits);
  if (!last_to_arrive(count + grp, g1 - g0, last)) return false;
  sum_slices<W>(acc, part, slice, g0, g1, idx);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long o = idx(i);
    if (o >= 0) part[(size_t)(splits + grp) * slice + o] = acc[i];
  }
  if (!last_to_arrive(count + n_groups, n_groups, last)) return false;
  sum_slices<W>(acc, part, slice, splits, splits + n_groups, idx);
  return true;
}

// ----------------------------------------------------------- column sums
// The column sums of two quantities over every row, in a fixed order:
// stats holds two tables ([2, tiles_m + groups, ncols]: the sums of each
// row tile (or of each persistent block's tiles), then of each group of
// GEMM_GROUP of them), counts the arrival counts (zeros before the launch:
// [tiles_n * groups], then [tiles_n]; tiles_n column blocks of 64 or 128, as
// col_sums is called).
struct ColSums {
  float* stats;
  int* counts;
  float* out1;          // [ncols]: the first quantity's sums
  float* out2;          // [ncols]: the second's
  int ncols, tiles_m, tiles_n;
};

// The sums of rows [r0, r1) of the two tables at the block's BN columns (BN
// = 64 or 128), added in a fixed order: thread tid (2 tables x PH phases x
// BN columns, PH = 256 / (2 BN)) keeps 8 running sums of every PH-th row,
// which are then added in order, and at PH = 2 the two phases' totals
// through red.  The result is in the threads of phase 0: table tid / (PH BN),
// column n0 + tid % BN.
template <int BN>
__device__ __forceinline__ float col_sum_rows(const ColSums& a, float* red, int rows, int n0,
                                              int r0, int r1, int tid) {
  constexpr int PH = CONSUMERS / (2 * BN);
  const int which = tid / (PH * BN), c = tid % BN, ph = (tid / BN) % PH;
  float part[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) part[k] = 0.f;
  if (n0 + c < a.ncols) {
    const float* col = a.stats + (size_t)which * rows * a.ncols + n0 + c;
    int i = r0 + ph;
    for (; i + 7 * PH < r1; i += 8 * PH)
#pragma unroll
      for (int k = 0; k < 8; ++k) part[k] += __ldcg(col + (size_t)(i + PH * k) * a.ncols);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i + PH * k < r1) part[k] += __ldcg(col + (size_t)(i + PH * k) * a.ncols);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += part[k];
  if constexpr (PH == 1) return sum;
  consumers_sync(1);           // red's last readers are done
  red[tid] = sum;
  consumers_sync(1);
  return red[tid] + red[tid ^ BN];
}

// c1 and c2 (this thread's sums over its rows at columns 8 j + 2 t + e of a
// block of BN = 4 E columns, entry 2 j + e) added over the warp's 8 g, then
// written to the warp's rows of red ([2][8][BN] f32 of shared memory), or
// (ADD) added to what they hold: each warp owns its rows, so a block can
// keep running sums there over several tiles.
template <bool ADD, int E>
__device__ __forceinline__ void col_sums_warp(float (&c1)[E], float (&c2)[E], float* red) {
  constexpr int BN = 4 * E;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < E; ++i)
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
      c1[i] += __shfl_xor_sync(0xffffffffu, c1[i], x);
      c2[i] += __shfl_xor_sync(0xffffffffu, c2[i], x);
    }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < E / 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* r1 = red + warp * BN + 8 * j + 2 * t + e;
        float* r2 = red + (8 + warp) * BN + 8 * j + 2 * t + e;
        *r1 = ADD ? *r1 + c1[2 * j + e] : c1[2 * j + e];
        *r2 = ADD ? *r2 + c2[2 * j + e] : c2[2 * j + e];
      }
  }
}

// The block's sums in red (row mt of the tables, column block nt of BN
// columns) added over the 8 consumer warps in order and written to row mt
// of the tables; the last row of its group to arrive adds the group's rows
// in order, and the last group of the column block the groups' into out1
// and out2.  Consumer threads only, after a consumers_sync that follows
// red's last writes; `last` is a shared int.
template <int BN>
__device__ __forceinline__ void col_sums_tables(float* red, const ColSums& a, int mt, int nt,
                                                int* last) {
  constexpr int PH = CONSUMERS / (2 * BN);
  const int tid = threadIdx.x, n0 = nt * BN;
  const int rows = a.tiles_m + (a.tiles_m + GEMM_GROUP - 1) / GEMM_GROUP;   // of a table
  if (tid < 2 * BN) {
    const int which = tid / BN, c = tid % BN;
    float sum = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) sum += red[(8 * which + w8) * BN + c];
    if (n0 + c < a.ncols) a.stats[((size_t)which * rows + mt) * a.ncols + n0 + c] = sum;
  }
  const int grp = mt / GEMM_GROUP, n_groups = rows - a.tiles_m;
  const int g0 = grp * GEMM_GROUP, g1 = min(g0 + GEMM_GROUP, a.tiles_m);
  __threadfence();
  consumers_sync(1);
  if (tid == 0) *last = atomicAdd(a.counts + nt * n_groups + grp, 1) == g1 - g0 - 1;
  consumers_sync(1);
  if (!*last) return;
  __threadfence();
  float sum = col_sum_rows<BN>(a, red, rows, n0, g0, g1, tid);
  const int which = tid / (PH * BN), c = tid % BN;
  const bool mine = (tid / BN) % PH == 0 && n0 + c < a.ncols;
  if (mine) a.stats[((size_t)which * rows + a.tiles_m + grp) * a.ncols + n0 + c] = sum;
  __threadfence();
  consumers_sync(1);
  if (tid == 0) *last = atomicAdd(a.counts + a.tiles_n * n_groups + nt, 1) == n_groups - 1;
  consumers_sync(1);
  if (!*last) return;
  __threadfence();
  sum = col_sum_rows<BN>(a, red, rows, n0, a.tiles_m, rows, tid);
  if (mine) (which ? a.out2 : a.out1)[n0 + c] = sum;
}

// The block (row tile mt, column block nt of BN = 4 E columns: 64 or 128)
// adds c1 and c2 over its rows (col_sums_warp, then col_sums_tables).
// Consumer threads only; `last` is a shared int.
template <int E>
__device__ __forceinline__ void col_sums(float (&c1)[E], float (&c2)[E], float* red,
                                         const ColSums& a, int mt, int nt, int* last) {
  consumers_sync(1);   // red's last readers (a previous call's col_sum_rows) are done
  col_sums_warp<false>(c1, c2, red);
  consumers_sync(1);
  col_sums_tables<4 * E>(red, a, mt, nt, last);
}

// ------------------------------------------------------------ TMA store
// A box of shared memory at src stored to the tensor of `map` at (col, row,
// z) by the TMA unit; what lies past the tensor is not written.  The issuing
// thread commits (tma_adds_commit) and, before src is written again or the
// block ends, waits until the unit has read it (tma_store_read).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_store_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ----------------------------------------------------------- tensor maps
// A 3-D map over [d2, d1, d0] (innermost d0, rows of d0 elements of esz
// bytes) in boxes [b2, b1, b0]; what lies past the tensor reads as zeros.
// swizzle: 128-byte (b0 esz = 128) or none.
inline bool tma_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esz, int d0,
                    int d1, int d2, int b0, int b1, int b2, bool swizzle = true) {
  cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  cuuint64_t strides[2] = {(cuuint64_t)d0 * esz, (cuuint64_t)d0 * d1 * esz};
  cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  cuuint32_t one[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 3, const_cast<void*>(ptr), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same for f32 (f32 true) or bf16 elements, boxes of 128 bytes.
inline bool tma_map_sw128(CUtensorMap* map, const void* ptr, bool f32, int d0, int d1, int d2,
                          int b1, int b2) {
  return tma_map(map, ptr, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 f32 ? 4 : 2, d0, d1, d2, f32 ? 32 : 64, b1, b2);
}

// A vector of n f32 as a map in boxes of `box` (no swizzle; the row
// pitches of its unit dims are only rounded to what cuTensorMapEncodeTiled
// takes); what lies past n reads as zeros.
inline bool vec_map(CUtensorMap* map, const void* ptr, int n, int box) {
  cuuint64_t dims[3] = {(cuuint64_t)n, 1, 1};
  const cuuint64_t pitch = ((cuuint64_t)n * 4 + 15) / 16 * 16;
  cuuint64_t strides[2] = {pitch, pitch};
  cuuint32_t boxes[3] = {(cuuint32_t)box, 1, 1};
  cuuint32_t one[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                                dims, strides, boxes, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
