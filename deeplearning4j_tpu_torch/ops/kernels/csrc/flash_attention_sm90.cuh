// Hopper (sm_90a) blocks of the bf16 flash kernels: the key-tile kernel of
// the merged backward (with ds k added to dq) and of the split backward's
// dk/dv kernel (without); and the query-tile ring and producer that the
// split backward's dq kernel (here) and the forward
// (flash_attention_fwd.cu) share.  At the end, the pieces of the f32
// kernels: f32 tiles, tensor maps and TMA boxes, the TF32 split, the
// three-pass wgmma, and the f32 key-tile body of the merged backward and
// of the split backward's dk/dv kernel.
//
// A block is one producer warpgroup and two consumer warpgroups (NWG).  One
// warp of the producer keeps TMA loads in flight: 3-D tensor maps over
// [BH, T, ld], so rows past T (a tail tile) come in as zeros and never from
// the next head, in boxes of 64 rows x 64 columns (32 at D = 32) that the
// TMA writes in the 128-byte (64-byte) swizzled layout that wgmma's
// descriptors name.  Tiles that stay (k and v of a key tile, q and dout of a
// query tile) load once; the streamed tiles go through a ring of STAGES
// buffers behind full and empty mbarriers, with lse and delta of their rows
// (read by the producer's lanes ahead of the wait for a free stage).
// setmaxnreg moves registers from the producer (40) to the consumers (232).
// Each consumer warpgroup owns 64 rows of the block's tile (keys, or query
// rows) as the M of its wgmma:
//
//   key tile:   s^T = k q^T, dp^T = v dout^T    (wgmma, both from shared memory)
//               p^T, ds^T in the accumulators (p_ds2), rounded to bf16 there
//               dv += p^T dout, dk += ds^T q    (wgmma, A from registers)
//               DQ: ds^T to shared memory, dq_tile = ds k (wgmma, the two
//               warpgroups split its columns), handed to a writer warp of
//               the producer warpgroup, which adds it into dq by TMA
//               reduce-add in key-tile order (the ordered sum,
//               flash_attention.cuh) while the consumers go on
//   dq kernel:  s = q k^T, dp = dout v^T; ds rounded to bf16 in registers;
//               dq += ds k (A from registers), dq in f32 registers
//   forward:    s = q k^T; the online softmax in registers; o += p v (A
//               from registers), o in f32 registers
//
// The accumulator of an m64nN wgmma holds, in thread (warp w, lane 4 g + t)
// of the warpgroup, rows 16 w + g and 16 w + g + 8 at columns 8 j + 2 t and
// 8 j + 2 t + 1 (entries 4 j + 2 h + e), which rounded to bf16 pairs is the
// register A operand of the next product (k16 step kk: entries 8 kk..8 kk + 7).
// p and ds come from exp2 with scale log2(e) and lse log2(e) folded in, and
// the per-entry visibility rule runs only on tiles that the Tk tail, the key
// mask or the causal rule cut.
//
// The key-tile kernels write 64 output columns per block (key_tile_slab):
// at D = 128 two blocks share a key tile, each computing s and dp over all
// 128 columns, because 128-column dk and dv beside s^T and dp^T leave wgmma
// too few registers (ptxas serializes and spills).  Past D = 128 (WIDE) the
// scores run over every CH-column chunk of the head dim, each chunk streamed
// through the ring with its k and v (query-tile kernels: q, and dout) rows,
// and one more stage brings the block's slab for the products (64 columns
// in the key-tile kernels, 128 in the query-tile kernels).
#pragma once

#include "flash_attention.cuh"

namespace {

constexpr int NWG = 2;                                // consumer warpgroups of a block
constexpr int CONSUMERS = NWG * WG_THREADS;
constexpr int SM90_THREADS = CONSUMERS + WG_THREADS;  // and the producer warpgroup
constexpr int TR = 64;                                // rows of a box, and of a wgmma's M
constexpr int CH = 64;                                // WIDE: columns of a score chunk
constexpr int SMEM_BUDGET = 225 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

// The four tensor maps and the arguments: one __grid_constant__ parameter.


// A tile W columns wide in shared memory: W / BX boxes of BX columns, each
// its rows' BX columns in one 128-byte (64-byte at W = 32) swizzled row.
template <int W>
struct Box {
  static constexpr int BX = W < 64 ? W : 64;
  static constexpr int ROW = BX * 2;                  // bytes of a row in a box
  static constexpr int N = W / BX;
  static constexpr uint64_t LAYOUT = BX == 64 ? 1 : 2;   // wgmma: 128B or 64B swizzle
};

constexpr int round_kb(int bytes) { return (bytes + 1023) / 1024 * 1024; }
constexpr int stages_for(int fixed, int stage) {
  return (SMEM_BUDGET - fixed) / stage < 4 ? (SMEM_BUDGET - fixed) / stage : 4;
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(bh)
      : "memory");
}

// Rows [row0, row0 + R) and columns [col0, col0 + W) of head bh into an
// R-row tile at dst: box b, rows 64 h.. at dst + (b R + 64 h) ROW.
template <int W, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col0, int row0, int bh) {
  using B = Box<W>;
#pragma unroll
  for (int b = 0; b < B::N; ++b)
#pragma unroll
    for (int h = 0; h < R / TR; ++h)
      tma_load(dst + (b * R + h * TR) * B::ROW, map, bar, col0 + b * B::BX, row0 + h * TR, bh);
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand: rows [r0, r0 + 64) of an R-row W-wide tile at base, the
// contraction over columns [c, c + 16)
template <int W, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int r0, int c) {
  using B = Box<W>;
  return gmma_desc(base + ((c / B::BX) * R + r0) * B::ROW + (c % B::BX) * 2, 16, 8 * B::ROW,
                   B::LAYOUT);
}

// N-major operand (B of a product whose contraction runs down the rows):
// rows [r, r + 16) of an R-row W-wide tile at base, its columns from c on
template <int W, int R>
__device__ __forceinline__ uint64_t desc_n(uint32_t base, int r, int c) {
  using B = Box<W>;
  return gmma_desc(base + ((c / B::BX) * R + r) * B::ROW + (c % B::BX) * 2, R * B::ROW,
                   8 * B::ROW, B::LAYOUT);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lse and delta of a row in the form the fast p_ds takes: lse log2(e) (+inf
// on a dead row or a row past Tq, so that p = 0 there) and delta scale.
__device__ __forceinline__ float2 row_terms(const BwdArgs& a, int bh, int qg) {
  if (qg >= a.tq) return make_float2(INFINITY, 0.f);
  const float lse = a.lse[(size_t)bh * a.tq + qg];
  return make_float2(lse > NEG_INF * 0.5f ? lse * LOG2E : INFINITY,
                     a.delta[(size_t)bh * a.tq + qg] * a.scale);
}

// One score entry's p and ds from s = q.k, dp = dout.v and row_terms:
//     p  = exp(s * scale - lse)   on a visible key (seen) of a live row, else 0
//     ds = p * (dp - delta) * scale
// as p = 2^(s scale log2(e) - lse log2(e)), ds = p (dp scale - delta scale).
__device__ __forceinline__ float2 p_ds2(float s, float dp, float2 row, float sl2, float scale,
                                        bool seen) {
  const float p = seen ? ex2(fmaf(s, sl2, -row.x)) : 0.f;
  return make_float2(p, p * fmaf(dp, scale, -row.y));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The k16 steps of an m64nN accumulator (N / 16 of them) as bf16 A operands.
template <int N>
__device__ __forceinline__ void a_operands(uint32_t (&r)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned char* smem_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// d (64 x 64) += a (64 x 16, K-major) . b (16 x 64, K-major): both from shared memory
__device__ __forceinline__ void wgmma_kk(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128) += a (64 x 16, K-major) . b (16 x 128, K-major): both from shared memory
__device__ __forceinline__ void wgmma_kk(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 16) += a (64 x 16, M-major) . b (16 x 16, N-major): both from shared memory
__device__ __forceinline__ void wgmma_mn(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32) += a (64 x 16, M-major) . b (16 x 32, N-major): both from shared memory
__device__ __forceinline__ void wgmma_mn(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32) += a (64 x 16, registers) . b (16 x 32, N-major, shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64, N-major, shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 128) += a (64 x 16, registers) . b (16 x 128, N-major, shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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


// ------------------------------------------------------- key-tile kernel
// The output columns of a key-tile block: all of D up to 64; a 64-column
// slab past that (blockIdx / ticket slab z), where dk and dv of 128 columns
// beside s^T and dp^T leave wgmma too few registers to pipeline (ptxas
// serializes and spills).  The block still computes s and dp over all of D
// (WIDE: over every CH-column chunk of the head dim).
template <int D, bool WIDE>
__host__ __device__ constexpr int key_tile_slab() { return WIDE ? D : (D > 64 ? 64 : D); }

// Shared memory of the key-tile kernel: the resident k and v tiles (WIDE:
// the k slab, for dq), ds^T (DQ), the ring, the barriers.  A product stage
// holds q and dout (at all D columns; WIDE: at the block's slab) and
// lse log2(e), delta scale of the query tile; a WIDE chunk stage holds q,
// dout, k and v at CH columns.
template <int D, bool DQ, bool WIDE>
struct KeyTileSmem {
  static constexpr int KB = TR * NWG;                        // keys of a block
  static constexpr int PROD = 2 * TR * D * 2;
  static constexpr int CHUNK = WIDE ? (2 * TR + 2 * KB) * CH * 2 : 0;
  static constexpr int AUX = PROD > CHUNK ? PROD : CHUNK;    // lse, delta within a stage
  static constexpr int STAGE = round_kb(AUX + 2 * TR * 4);
  static constexpr int RES = WIDE ? (DQ ? KB * D * 2 : 0) : 2 * KB * D * 2;
  static constexpr int DS = DQ ? KB * TR * 2 : 0;
  // DQ: two f32 dq tiles [64, slab] for the writer, in 128-byte swizzled
  // boxes of 32 columns, as the TMA reads them
  static constexpr int DQT = TR * key_tile_slab<D, WIDE>() * 4;
  static constexpr int DQB = DQ ? 2 * DQT : 0;
  static constexpr int STAGES = stages_for(RES + DS + DQB + 2048, STAGE);
  static constexpr int BARS = 2 * STAGES + 1 + (DQ ? 4 : 0);
  static constexpr size_t BYTES = 1024 + RES + DS + DQB + STAGES * STAGE + 8 * BARS;
};

// One block owns KB = 128 keys (kt) of one (batch, head) bh, and slab z of
// the output columns, and walks the 64-row query tiles, skipping those
// wholly before a causal key tile, with dk and dv in the consumers'
// registers.  With DQ it adds each query tile's ds k into dq in key-tile
// order (ordered sum, flash_attention.cuh).
template <int D, bool DQ, bool WIDE>
__device__ __forceinline__ void key_tile_body(const TmaArgs& p, int kt, int bh, int z) {
  using L = KeyTileSmem<D, DQ, WIDE>;
  // SL: the block's output columns; NQ: a warpgroup's columns of dq
  constexpr int KB = L::KB, SL = key_tile_slab<D, WIDE>(), NQ = SL / NWG;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  unsigned char* smem = smem_1024(flash_smem);
  const BwdArgs& a = p.a;
  const uint32_t res = smem_u32(smem), ds_t = res + L::RES, dq_t = ds_t + L::DS,
                 ring = dq_t + L::DQB;
  unsigned char* ring_p = smem + L::RES + L::DS + L::DQB;
  const uint32_t full = ring + L::STAGES * L::STAGE;   // barriers, 8 bytes each
  const uint32_t empty = full + 8 * L::STAGES;
  const uint32_t res_bar = empty + 8 * L::STAGES;
  const uint32_t dq_full = res_bar + 8;        // DQ: a dq tile is written; it is added
  const uint32_t dq_free = dq_full + 16;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ld = WIDE ? a.ld : D, col0 = z * SL, k0 = kt * KB;
  // the block's columns within a product stage's q and dout, and within the resident k
  const int pc = WIDE ? 0 : col0;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, NWG * 4);
    }
    mbar_init(res_bar, 1);
    if constexpr (DQ) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(dq_full + 8 * b, CONSUMERS);
        mbar_init(dq_free + 8 * b, 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == NWG) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if constexpr (DQ) {
      if (tid == CONSUMERS + 32) {
        // the writer: each query tile's dq tile added into dq in key-tile
        // order (ordered sum, flash_attention.cuh), by TMA reduce-add
        int n = 0;
        for (int qt = 0; qt < a.n_qt; ++qt) {
          if (skipped(a, qt * TR, TR, k0)) continue;
          const int b = n & 1;
          mbar_wait(dq_full + 8 * b, (n >> 1) & 1);
          int* flag = dq_flag(a, bh, z, qt);
          flag_wait(flag, kt);
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
          for (int x = 0; x < SL / 32; ++x)
            tma_add_box(&p.dq, dq_t + b * L::DQT + x * TR * 128, col0 + 32 * x, qt * TR, bh);
          tma_adds_commit();
          tma_adds_done();
          st_release(flag, kt + 1);
          mbar_arrive(dq_free + 8 * b);
          ++n;
        }
      }
    }
    if (tid >= CONSUMERS + 32) return;
    if (lane == 0) {
      if constexpr (!WIDE) {
        mbar_expect_tx(res_bar, L::RES);
        tma_tile<D, KB>(res, &p.k, res_bar, 0, k0, bh);
        tma_tile<D, KB>(res + KB * D * 2, &p.v, res_bar, 0, k0, bh);
      } else if constexpr (DQ) {
        mbar_expect_tx(res_bar, L::RES);
        tma_tile<D, KB>(res, &p.k, res_bar, col0, k0, bh);
      } else {
        mbar_arrive(res_bar);
      }
    }
    int it = 0;
    for (int qt = 0; qt < a.n_qt; ++qt) {
      const int q0 = qt * TR;
      if (skipped(a, q0, TR, k0)) continue;
      // the query tile's lse and delta, read before the wait for a free stage
      const float2 rows[2] = {row_terms(a, bh, q0 + lane), row_terms(a, bh, q0 + lane + 32)};
      if constexpr (WIDE) {
        for (int c = 0; c < ld; c += CH, ++it) {
          const int s = it % L::STAGES;
          const uint32_t st = ring + s * L::STAGE;
          mbar_wait(empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full + 8 * s, L::CHUNK);
            tma_tile<CH, TR>(st, &p.q, full + 8 * s, c, q0, bh);
            tma_tile<CH, TR>(st + TR * CH * 2, &p.dout, full + 8 * s, c, q0, bh);
            tma_tile<CH, KB>(st + 2 * TR * CH * 2, &p.k, full + 8 * s, c, k0, bh);
            tma_tile<CH, KB>(st + (2 * TR + KB) * CH * 2, &p.v, full + 8 * s, c, k0, bh);
          } else {
            mbar_arrive(full + 8 * s);
          }
        }
      }
      const int s = it % L::STAGES;
      const uint32_t st = ring + s * L::STAGE;
      mbar_wait(empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect(full + 8 * s, L::PROD);
        tma_tile<D, TR>(st, &p.q, full + 8 * s, WIDE ? col0 : 0, q0, bh);
        tma_tile<D, TR>(st + TR * D * 2, &p.dout, full + 8 * s, WIDE ? col0 : 0, q0, bh);
      }
      float* aux = reinterpret_cast<float*>(ring_p + s * L::STAGE + L::AUX);
      aux[lane] = rows[0].x;
      aux[lane + 32] = rows[1].x;
      aux[TR + lane] = rows[0].y;
      aux[TR + lane + 32] = rows[1].y;
      mbar_arrive(full + 8 * s);
      ++it;
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warpgroup(), wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;
  int kg[2];                                   // this thread's two keys
  bool key_ok[2];                              // each below Tk and unmasked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kg[h] = k0 + 64 * wg + 16 * wq + g + 8 * h;
    key_ok[h] = kg[h] < a.tk && (km == nullptr || km[kg[h]] > 0.f);
  }
  // whether every key of this warp's 16 is below Tk and unmasked, and the
  // last of them (a tile the causal rule cuts needs the per-entry rule)
  const bool keys_all = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
  const int k_last = k0 + 64 * wg + 16 * wq + 15;
  const float sl2 = a.scale * LOG2E;
  // this thread's first ds^T entry (its key row, query 2 t) and dq tile entry
  // (row 16 wq + g, column 2 t within its 16-byte chunk), before swizzling
  const uint32_t ds_row = ds_t + (64 * wg + 16 * wq + g) * 128 + 4 * t;
  const uint32_t dq_row = dq_t + (16 * wq + g) * 128 + 8 * (t & 1);
  float dk[SL / 2], dv[SL / 2];                // keys kg[h], columns col0 + 8 j + 2 t + e
  zero(dk);
  zero(dv);
  mbar_wait(res_bar, 0);
  int it = 0, n = 0;                           // n: dq tiles handed to the writer
  for (int qt = 0; qt < a.n_qt; ++qt) {
    const int q0 = qt * TR;
    if (skipped(a, q0, TR, k0)) continue;
    // s^T = k q^T and dp^T = v dout^T: keys kg[h], queries 8 j + 2 t + e
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += CH, ++it) {
        const int s = it % L::STAGES;
        const uint32_t sa = ring + s * L::STAGE;
        mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
        reg_fence(st);
        reg_fence(dpt);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma_kk(st, desc_k<CH, KB>(sa + 2 * TR * CH * 2, 64 * wg, kk * 16),
                   desc_k<CH, TR>(sa, 0, kk * 16), 1);
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma_kk(dpt, desc_k<CH, KB>(sa + (2 * TR + KB) * CH * 2, 64 * wg, kk * 16),
                   desc_k<CH, TR>(sa + TR * CH * 2, 0, kk * 16), 1);
        wg_commit();
        wg_wait();
        reg_fence(st);
        reg_fence(dpt);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
    const int s = it % L::STAGES;
    const uint32_t sa = ring + s * L::STAGE;
    mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
    if constexpr (!WIDE) {
      reg_fence(st);
      reg_fence(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_kk(st, desc_k<D, KB>(res, 64 * wg, kk * 16), desc_k<D, TR>(sa, 0, kk * 16), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_kk(dpt, desc_k<D, KB>(res + KB * D * 2, 64 * wg, kk * 16),
                 desc_k<D, TR>(sa + TR * D * 2, 0, kk * 16), 1);
      wg_commit();
      wg_wait();
      reg_fence(st);
      reg_fence(dpt);
    }

    // p^T and ds^T in place, rounded to bf16 as the A operands of the products
    const float* aux = reinterpret_cast<const float*>(ring_p + s * L::STAGE + L::AUX);
    const bool exact = keys_all && (!a.causal || a.q_offset + q0 >= a.k_offset + k_last);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool seen = exact || (key_ok[h] && causal_ok(a, q0 + ql, kg[h]));
        const float2 pd = p_ds2(st[4 * j + e], dpt[4 * j + e], make_float2(aux[ql], aux[TR + ql]),
                                sl2, a.scale, seen);
        st[4 * j + e] = pd.x;
        dpt[4 * j + e] = pd.y;
      }
    uint32_t pa[4][4], da[4][4];
    a_operands<64>(pa, st);
    a_operands<64>(da, dpt);

    // dv += p^T dout, dk += ds^T q: the stage's q and dout rows as N-major B,
    // at the block's columns
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, pa[kk], desc_n<D, TR>(sa + TR * D * 2, kk * 16, pc), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, da[kk], desc_n<D, TR>(sa, kk * 16, pc), 1);
    wg_commit();

    if constexpr (DQ) {
      // ds^T [key][query] into 128-byte swizzled rows, read back as the
      // M-major A of dq_tile = ds k; this warpgroup's NQ columns
      consumers_sync(1);                       // the last tile's dq products are done
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // key row 64 wg + 16 wq + g + 8 (e & 1), queries 16 kk + 8 (e >> 1) + 2 t, +1
          st_shared(ds_row + 1024 * (e & 1) + (((2 * kk + (e >> 1)) ^ g) << 4), da[kk][e]);
        }
      // dk, dv done: p^T and ds^T leave the registers before dq comes in
      wg_wait();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pa);
      reg_fence(da);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync(1);
      float dq[NQ / 2];   // queries 16 wq + g + 8 h, columns wg NQ + 8 j + 2 t + e
      zero(dq);
      reg_fence(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        wgmma_mn(dq, gmma_desc(ds_t + kk * 16 * 128, KB * 128, 1024, 1),
                 desc_n<D, KB>(res, kk * 16, pc + wg * NQ), 1);
      wg_commit();
      wg_wait();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ++it;
      // to the writer: queries 16 wq + g + 8 h, columns wg NQ + 8 j + 2 t + e
      const int b = n & 1;
      mbar_wait(dq_free + 8 * b, ((n >> 1) & 1) ^ 1);
      const uint32_t tile = dq_row + b * L::DQT;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row 16 wq + g + 8 h, column wg NQ + 8 j + 2 t: its box of 32 columns, and
          // within it the 16-byte chunk (8 j + 2 t) / 4 % 8, swizzled by the row
          const int c = wg * NQ + 8 * j + 2 * t;
          st_shared(tile + (c >> 5) * TR * 128 + 1024 * h + ((((c & 31) >> 2) ^ g) << 4),
                    dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(dq_full + 8 * b);
      ++n;
    } else {
      wg_wait();
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pa);
      reg_fence(da);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ++it;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kg[h] >= a.tk) continue;
    const size_t row = ((size_t)bh * a.tk + kg[h]) * ld + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < SL / 8; ++j) {
      *reinterpret_cast<float2*>(a.dk + row + 8 * j) =
          make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(a.dv + row + 8 * j) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------- query-tile kernels
// Shared memory of a query-tile kernel, whose block owns QB = 128 query rows
// of one (batch, head) and walks the tiles of KN keys: the split backward's
// dq kernel (NR = 2 query-side tensors, q and dout, with k and v as their
// key-side partners; KN = 64) and the forward (NR = 1: q, with k).  Not
// WIDE, the query-side rows stay resident and a product stage holds k and
// v of a key tile; WIDE, a chunk stage holds the query-side rows and their
// partners at CH columns, and the product stage one key-side tensor at the
// block's slab.  Each product stage ends with its keys' visibility (below
// Tk, unmasked) and whether all are seen.
template <int D, bool WIDE, int NR, int KN = TR>
struct QTileSmem {
  static constexpr int QB = TR * NWG;                         // query rows of a block
  static constexpr int PROD = (WIDE ? 1 : 2) * KN * D * 2;
  static constexpr int CHUNK = WIDE ? NR * (QB + KN) * CH * 2 : 0;
  static constexpr int AUX = PROD > CHUNK ? PROD : CHUNK;
  static constexpr int STAGE = round_kb(AUX + (KN + 1) * 4);
  static constexpr int RES = WIDE ? 0 : NR * QB * D * 2;
  static constexpr int STAGES = stages_for(RES + 2048, STAGE);
  static constexpr size_t BYTES = 1024 + RES + STAGES * STAGE + 8 * (2 * STAGES + 1);
};

// The addresses of a query-tile kernel's resident rows, ring and barriers
// (8 bytes each: full and empty of every stage, then the resident rows').
template <class L>
struct QTileRing {
  unsigned char* smem;
  uint32_t res, ring, full, empty, res_bar;

  __device__ explicit QTileRing(unsigned char* base) : smem(base) {
    res = smem_u32(base);
    ring = res + L::RES;
    full = ring + L::STAGES * L::STAGE;
    empty = full + 8 * L::STAGES;
    res_bar = empty + 8 * L::STAGES;
  }
  __device__ uint32_t stage(int s) const { return ring + s * L::STAGE; }
  // the visibility of stage s's keys, and after them whether all are seen
  __device__ float* aux(int s) const {
    return reinterpret_cast<float*>(smem + L::RES + s * L::STAGE + L::AUX);
  }
  __device__ void init() const {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, NWG * 4);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer warp of a query-tile kernel: the block's rows of the query-
// side maps qm (resident; WIDE: streamed per key tile in CH-column chunks
// with their key-side partners km), then per key tile the product stage
// (k and v; WIDE: the map `slab` at the block's columns col0) with its keys'
// visibility (kmask: the batch row of the key mask, or null).
template <int D, bool WIDE, int NR, int KN>
__device__ __forceinline__ void q_tile_producer(const QTileRing<QTileSmem<D, WIDE, NR, KN>>& r,
                                                const CUtensorMap* const (&qm)[NR],
                                                const CUtensorMap* const (&km)[NR],
                                                const CUtensorMap* k, const CUtensorMap* v,
                                                const CUtensorMap* slab, const float* kmask,
                                                int tk, int n_kt, int q0, int bh, int col0,
                                                int ld) {
  using L = QTileSmem<D, WIDE, NR, KN>;
  constexpr int QB = L::QB, KV = KN / 32;   // KV: keys of a lane
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    if constexpr (!WIDE) {
      mbar_expect_tx(r.res_bar, L::RES);
#pragma unroll
      for (int i = 0; i < NR; ++i)
        tma_tile<D, QB>(r.res + i * QB * D * 2, qm[i], r.res_bar, 0, q0, bh);
    } else {
      mbar_arrive(r.res_bar);
    }
  }
  int it = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KN;
    bool vis[KV], mine = true;
#pragma unroll
    for (int h = 0; h < KV; ++h) {
      const int kg = k0 + lane + 32 * h;
      vis[h] = kg < tk && (kmask == nullptr || kmask[kg] > 0.f);
      mine = mine && vis[h];
    }
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += CH, ++it) {
        const int s = it % L::STAGES;
        const uint32_t st = r.stage(s), bar = r.full + 8 * s;
        mbar_wait(r.empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bar, L::CHUNK);
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            tma_tile<CH, QB>(st + i * QB * CH * 2, qm[i], bar, c, q0, bh);
            tma_tile<CH, KN>(st + (NR * QB + i * KN) * CH * 2, km[i], bar, c, k0, bh);
          }
        } else {
          mbar_arrive(bar);
        }
      }
    }
    const int s = it % L::STAGES;
    const uint32_t st = r.stage(s), bar = r.full + 8 * s;
    mbar_wait(r.empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect(bar, L::PROD);
      if constexpr (WIDE) {
        tma_tile<D, KN>(st, slab, bar, col0, k0, bh);
      } else {
        tma_tile<D, KN>(st, k, bar, 0, k0, bh);
        tma_tile<D, KN>(st + KN * D * 2, v, bar, 0, k0, bh);
      }
    }
    float* aux = r.aux(s);
    const bool all = __all_sync(0xffffffffu, mine);
#pragma unroll
    for (int h = 0; h < KV; ++h) aux[lane + 32 * h] = vis[h] ? 1.f : 0.f;
    if (lane == 0) aux[KN] = all ? 1.f : 0.f;
    mbar_arrive(bar);
    ++it;
  }
}

// ------------------------------------------------------------- dq kernel
// One block owns QB = 128 query rows (blockIdx.x) of one (batch, head)
// (blockIdx.y) and slab blockIdx.z of dq, and walks the 64-key tiles up to
// the last one its rows see, with dq in the consumers' registers; in bf16
// ds is rounded before ds k and p is not, as the JAX kernel does.
template <int D, bool WIDE>
__global__ void __launch_bounds__(SM90_THREADS, 1)
fa_dq_bf16_kernel(const __grid_constant__ TmaArgs p) {
  using L = QTileSmem<D, WIDE, 2>;
  constexpr int QB = L::QB;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  const QTileRing<L> r(smem_1024(flash_smem));
  const BwdArgs& a = p.a;
  const uint32_t res = r.res, ring = r.ring, full = r.full, empty = r.empty;
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * QB;
  const int ld = WIDE ? a.ld : D, col0 = WIDE ? blockIdx.z * D : 0;
  const int n_kt = key_tiles(a.tk, a.causal, a.q_offset, a.k_offset, min(q0 + QB, a.tq) - 1);
  if (tid == 0) r.init();
  __syncthreads();

  if (warpgroup() == NWG) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid >= CONSUMERS + 32) return;
    const CUtensorMap* const qm[2] = {&p.q, &p.dout};
    const CUtensorMap* const km[2] = {&p.k, &p.v};
    q_tile_producer<D, WIDE, 2, TR>(r, qm, km, &p.k, &p.v, &p.k,
                                a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr,
                                a.tk, n_kt, q0, bh, col0, ld);
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warpgroup(), wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  int qg[2];
  float2 rows[2];                               // row_terms of rows qg[h]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qg[h] = q0 + 64 * wg + 16 * wq + g + 8 * h;
    rows[h] = row_terms(a, bh, qg[h]);
  }
  const int q_first = q0 + 64 * wg + 16 * wq;   // this warp's first row
  const float sl2 = a.scale * LOG2E;
  float dq[D / 2];                              // rows qg[h], columns 8 j + 2 t + e
  zero(dq);
  mbar_wait(r.res_bar, 0);
  int it = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TR;
    // s = q k^T and dp = dout v^T: rows qg[h], keys 8 j + 2 t + e
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    if constexpr (WIDE) {
      for (int c = 0; c < ld; c += CH, ++it) {
        const int s = it % L::STAGES;
        const uint32_t sa = ring + s * L::STAGE;
        mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
        reg_fence(sc);
        reg_fence(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma_kk(sc, desc_k<CH, QB>(sa, 64 * wg, kk * 16),
                   desc_k<CH, TR>(sa + 2 * QB * CH * 2, 0, kk * 16), 1);
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma_kk(dp, desc_k<CH, QB>(sa + QB * CH * 2, 64 * wg, kk * 16),
                   desc_k<CH, TR>(sa + (2 * QB + TR) * CH * 2, 0, kk * 16), 1);
        wg_commit();
        wg_wait();
        reg_fence(sc);
        reg_fence(dp);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
    const int s = it % L::STAGES;
    const uint32_t sa = ring + s * L::STAGE;
    mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
    if constexpr (!WIDE) {
      reg_fence(sc);
      reg_fence(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_kk(sc, desc_k<D, QB>(res, 64 * wg, kk * 16), desc_k<D, TR>(sa, 0, kk * 16), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_kk(dp, desc_k<D, QB>(res + QB * D * 2, 64 * wg, kk * 16),
                 desc_k<D, TR>(sa + TR * D * 2, 0, kk * 16), 1);
      wg_commit();
      wg_wait();
      reg_fence(sc);
      reg_fence(dp);
    }
    // ds in place of s, rounded to bf16 as the A operand of dq += ds k
    const float* aux = r.aux(s);
    const bool exact =
        aux[TR] > 0.f && (!a.causal || a.q_offset + q_first >= a.k_offset + k0 + TR - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const bool seen = exact || (aux[kl] > 0.f && causal_ok(a, qg[h], k0 + kl));
        sc[4 * j + e] = p_ds2(sc[4 * j + e], dp[4 * j + e], rows[h], sl2, a.scale, seen).y;
      }
    uint32_t da[4][4];
    a_operands<64>(da, sc);
    reg_fence(dq);
    reg_fence(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, da[kk], desc_n<D, TR>(sa, kk * 16, 0), 1);
    wg_commit();
    wg_wait();
    reg_fence(dq);
    reg_fence(da);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    ++it;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qg[h] >= a.tq) continue;
    const size_t row = ((size_t)bh * a.tq + qg[h]) * ld + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(a.dq + row + 8 * j) =
          make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------- f32: three TF32 passes
// The f32 forward (flash_attention_fwd.cu) and merged backward
// (flash_attention_bwd.cu) run every product a.b on the tensor cores as
// three TF32 passes into one f32 accumulator,
//
//     a.b ~ a_hi.b_lo + a_lo.b_hi + a_hi.b_hi,
//
// where x_hi is x rounded to TF32 (cvt.rna.tf32.f32: to nearest, ties away
// from zero, the low 13 bits of the f32 word zero) and x_lo = x - x_hi,
// exact in f32 (|x_lo| <= 2^-11 |x|).  The tensor core reads x_lo as TF32
// by dropping its low 13 bits, which moves a term by less than 2^-21 |a b|,
// and the term a_lo.b_lo left out is below 2^-22 |a b|: each product keeps
// about 2^-20 of sum |a_i b_i| (the JAX kernels' Precision.HIGHEST), where a
// single TF32 pass keeps 2^-11.  No product runs in one pass.
//
// TF32 wgmma takes both shared-memory operands K-major (the transpose flags
// exist for 16-bit types only).  Here A always comes from registers, read
// from shared memory in whatever layout its tile has (so A needs no
// transposed copy) and split there; every B is a K-major tile whose hi and
// lo halves lie in shared memory.  The kernels take q, k, v and dout as they
// are: the spare warps of the producer warpgroup (prep) turn each tile the
// TMA brought into the B tiles a product needs, in place (x -> x_hi, x_lo
// beside it) or transposed (v^T for the forward's o += p v, k^T for the
// backward's dq = ds k), between the TMA's full barrier and the consumers'
// ready barrier.
//
// An f32 tile of R rows and W columns is W / 32 boxes of R rows x 32
// columns, each row one 128-byte line in the TMA's 128-byte swizzle (the
// 16-byte chunk j of row r at chunk j ^ r % 8), as the TMA writes boxes of
// 32 columns x 64 rows and as wgmma's K-major descriptors read them.
constexpr int SMEM_MAX = 227 * 1024;          // shared memory a block can have

// Byte offset of element (r, c) in an f32 tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t f32_at(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// K-major operand: all R rows of an f32 tile at base, the 8-column k-step at column c
template <int R>
__device__ __forceinline__ uint64_t desc_f32(uint32_t base, int c) {
  return gmma_desc(base + (c >> 5) * (R * 128) + ((c & 31) << 2), 16, 1024, 1);
}

// Rows [row0, row0 + R) and columns [col0, col0 + W) of head bh of an f32
// map (boxes of 32 columns x 64 rows) into an R-row tile at dst.
template <int W, int R>
__device__ __forceinline__ void tma_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int col0, int row0, int bh) {
#pragma unroll
  for (int b = 0; b < W / 32; ++b)
#pragma unroll
    for (int h = 0; h < R / TR; ++h)
      tma_load(dst + (b * R + h * TR) * 128, map, bar, col0 + 32 * b, row0 + h * TR, bh);
}

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ld_f32(const unsigned char* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// The A operand of one k-step (CUTLASS's tf32 ALayout_64x8): register i of
// lane 4 g + t of warp wq holds A(m + 8 (i & 1), k + 4 (i >> 1)), with m =
// m0 + 16 wq + g and k = k0 + t.  From an R-row tile whose row m, column k
// holds A(m, k), or (TRANS) whose row k, column m does: split into hi and lo
// here (a_split), or read from a tile's hi and lo halves lo_off bytes apart
// (a_pair).
template <int R, bool TRANS>
__device__ __forceinline__ uint32_t a_off(int m, int k) {
  return TRANS ? f32_at<R>(k, m) : f32_at<R>(m, k);
}

template <int R, bool TRANS>
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const unsigned char* tile, int m, int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(ld_f32(tile, a_off<R, TRANS>(m + 8 * (i & 1), k + 4 * (i >> 1))), hi[i], lo[i]);
}

template <int R, bool TRANS>
__device__ __forceinline__ void a_pair(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const unsigned char* tile, int lo_off, int m, int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t off = a_off<R, TRANS>(m + 8 * (i & 1), k + 4 * (i >> 1));
    hi[i] = __float_as_uint(ld_f32(tile, off));
    lo[i] = __float_as_uint(ld_f32(tile + lo_off, off));
  }
}

// The same from an R-row tile at the shared address `tile` whose row m,
// column k holds A(m, k), by one ldmatrix: its four 8 x 8 blocks of 16-bit
// words are four 8-row x 4-column blocks of f32 (rows m0 + 8 (j & 1), columns
// k0 + 4 (j >> 1) for block j; lane 8 j + r names row r of block j), and
// lane 4 g + t receives row g, column t of each: A's registers i = j.  m0:
// the warp's first row.
template <int R>
__device__ __forceinline__ void a_split_rows(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t tile,
                                             int m0, int k0, int lane) {
  const int j = lane >> 3;
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(tile + f32_at<R>(m0 + (lane & 7) + 8 * (j & 1), k0 + 4 * (j >> 1)))
               : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d (64 x N) += a (64 x 8, TF32 in registers) . b (8 x N, K-major TF32 in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . b over one k-step in three TF32 passes, the two small terms first
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32(d, a_hi, b_lo);
  wgmma_tf32(d, a_lo, b_hi);
  wgmma_tf32(d, a_hi, b_hi);
}

// prep: the f32 words of a tile (bytes long) -> x_hi in place and x_lo at
// lo, 16 bytes a step over threads i0, i0 + step, ... (the split is
// elementwise, so the swizzle does not matter)
__device__ __forceinline__ void split_in_place(unsigned char* tile, unsigned char* lo, int bytes,
                                               int i0, int step) {
  for (int i = 16 * i0; i < bytes; i += 16 * step) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    float4 h;
    h.x = __uint_as_float(tf32_hi(x.x));
    h.y = __uint_as_float(tf32_hi(x.y));
    h.z = __uint_as_float(tf32_hi(x.z));
    h.w = __uint_as_float(tf32_hi(x.w));
    *reinterpret_cast<float4*>(tile + i) = h;
    *reinterpret_cast<float4*>(lo + i) = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
}

// The position of row r of a tile (a key) among the K columns of its
// transpose: r itself, or (PERM) permuted within each group of 8 so that
// the keys 2 t and 2 t + 1 that lane t holds in an accumulator (columns
// 8 j + 2 t + e) sit at the A operand's columns t and t + 4.
template <bool PERM>
__device__ __forceinline__ int key_column(int r) {
  return PERM ? (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1) : r;
}

// prep: an R-row, W-column tile at src -> its transpose (W rows, R columns),
// split into hi and lo tiles, element (r, c) at row c, column key_column(r)
template <int R, int W, bool PERM>
__device__ __forceinline__ void transpose_split(const unsigned char* src, unsigned char* hi,
                                                unsigned char* lo, int i0, int step) {
  for (int i = i0; i < R * W; i += step) {
    const int r = i % R, c = i / R;   // neighbouring threads: neighbouring rows
    const float x = ld_f32(src, f32_at<R>(r, c));
    const float h = __uint_as_float(tf32_hi(x));
    const uint32_t off = f32_at<W>(c, key_column<PERM>(r));
    *reinterpret_cast<float*>(hi + off) = h;
    *reinterpret_cast<float*>(lo + off) = x - h;
  }
}

// prep: an R-row, W-column tile as loaded -> x_hi in place and x_lo at lo,
// and its transpose (W rows, R columns, keys permuted: key_column<true>)
// split into t_hi and t_lo; each element read and written by one thread
template <int R, int W>
__device__ __forceinline__ void split_transpose(unsigned char* tile, unsigned char* lo,
                                                unsigned char* t_hi, unsigned char* t_lo,
                                                int i0, int step) {
  for (int i = i0; i < R * W; i += step) {
    const int r = i % R, c = i / R;   // neighbouring threads: neighbouring rows
    const uint32_t at = f32_at<R>(r, c), to = f32_at<W>(c, key_column<true>(r));
    const float x = ld_f32(tile, at);
    const float h = __uint_as_float(tf32_hi(x));
    *reinterpret_cast<float*>(tile + at) = h;
    *reinterpret_cast<float*>(lo + at) = x - h;
    *reinterpret_cast<float*>(t_hi + to) = h;
    *reinterpret_cast<float*>(t_lo + to) = x - h;
  }
}

// ------------------------------------------- f32 key-tile body (TF32 x 3)
// The key-tile block of the f32 merged backward (flash_attention_bwd.cu,
// DQ) and of the split backward's dk/dv kernel (flash_attention_bwd_split.cu,
// without DQ: no dq products, no writer, no flags or ticket).
//
// Shared memory of the block (one consumer warpgroup, KB = 64 keys, 64-row
// query tiles): k^T (hi | lo) at the block's SL output columns (the B of
// dq = ds k; below D = 128 also the A of s^T; KT_RES: held only where one
// of those needs it), v as loaded (below D = 128: the A of dp^T), P: p^T,
// then ds^T (hi | lo) [KB keys, QT queries] (the B of dv^T and dk^T, the A
// of dq; k as loaded before the first tile, for prep to transpose), DQ:
// NDQ dq tiles for the writer, and a ring of STAGES slots with their lse
// log2(e) and delta scale (aux).  Below D = 128 a slot holds a query tile's
// q and dout (hi | lo) over all of D.  From D = 128 on (CHUNKED: the
// block's slab of SL = 64 output columns of rows ld long) a score slot
// holds q and dout (hi | lo) and k and v as loaded, all at one CH-column
// chunk, and the product slot q and dout as loaded at the block's columns.
// Prep: warps 2-3 of the producer warpgroup; warp 1 is the dq writer (DQ).
template <int D, bool CHUNKED, bool DQ = true>
struct BwdF32Smem {
  static constexpr int KB = TR, QT = TR, PREP = 64;
  static constexpr int SL = CHUNKED ? 64 : D, CH = CHUNKED ? 32 : D;
  static constexpr bool KT_RES = DQ || !CHUNKED;
  static constexpr int KT = KT_RES ? SL * KB * 4 : 0, V = CHUNKED ? 0 : KB * D * 4;
  static constexpr int PT = KB * QT * 4;
  static constexpr int DQT = QT * SL * 4, NDQ = !DQ ? 0 : CHUNKED || D > 32 ? 1 : 2;
  static constexpr int TC = QT * CH * 4;                       // a [64, CH] f32 tile
  static constexpr int Q_HI = 0, Q_LO = TC, O_HI = 2 * TC, O_LO = 3 * TC;
  static constexpr int K_IN = 4 * TC, V_IN = 4 * TC + KB * CH * 4;   // CHUNKED score slots
  static constexpr int P_Q = 0, P_O = QT * SL * 4;                    // CHUNKED product slot
  static constexpr int SLOT = CHUNKED ? 4 * TC + 2 * KB * CH * 4 : 4 * TC;
  static constexpr int KT_HI = 0, KT_LO = KT, V_RES = 2 * KT, P_HI = 2 * KT + V,
                       P_LO = P_HI + PT, DQB = P_LO + PT, RING = DQB + NDQ * DQT;
  static constexpr int AUX = 4 * 2 * QT;
  static constexpr int VIS = 4 * (KB + 4);                     // the keys' visibility
  // what is left beside the fixed parts (and 16 bytes of static memory: the ticket)
  static constexpr int FIT =
      (SMEM_MAX - 16 - 1024 - RING - VIS - 8 * (2 + 2 * NDQ)) / (SLOT + AUX + 24);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int AUX0 = RING + STAGES * SLOT, VIS0 = AUX0 + STAGES * AUX, BARS = VIS0 + VIS;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (3 * STAGES + 2 + 2 * NDQ);
};

// A barrier of the consumer warpgroup alone.
__device__ __forceinline__ void consumer_wg_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_THREADS) : "memory");
}

// p^T or ds^T in the accumulators (keys r0 + 8 h, queries 8 j + 2 t + e)
// into P's hi and lo tiles [KB, QT]
__device__ __forceinline__ void to_p(unsigned char* hi, unsigned char* lo, const float (&x)[32],
                                     int r0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = f32_at<TR>(r0 + 8 * h, 8 * j + 2 * t);
      uint32_t xh[2], xl[2];
      split_tf32(x[4 * j + 2 * h], xh[0], xl[0]);
      split_tf32(x[4 * j + 2 * h + 1], xh[1], xl[1]);
      *reinterpret_cast<float2*>(hi + off) = make_float2(__uint_as_float(xh[0]), __uint_as_float(xh[1]));
      *reinterpret_cast<float2*>(lo + off) = make_float2(__uint_as_float(xl[0]), __uint_as_float(xl[1]));
    }
}

// d (64 x N) += A (64 x 64: 8 k-steps) . B (hi | lo at b_hi, b_lo: an R-row
// tile, K-major over the 64), three TF32 passes, and wait for it.  frag(kk,
// hi, lo) gives the A operand of k-step kk.
template <int R, int N, class Frag>
__device__ __forceinline__ void product(float (&d)[N], Frag&& frag, uint32_t b_hi, uint32_t b_lo) {
  uint32_t ah[8][4], al[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) frag(kk, ah[kk], al[kk]);
  reg_fence(d);
  reg_fence(ah);
  reg_fence(al);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma3(d, ah[kk], al[kk], desc_f32<R>(b_hi, 8 * kk), desc_f32<R>(b_lo, 8 * kk));
  wg_commit();
  wg_wait();
  reg_fence(d);
  reg_fence(ah);
  reg_fence(al);
}

// acc (64 x 64 keys) += A . P (hi | lo): the product in a fresh
// accumulator t, then added to acc in f32 (the tensor core's adds round
// toward zero: chained over every query tile into dk and dv, that bias would
// grow with Tq)
template <class Frag>
__device__ __forceinline__ void add_product(float (&acc)[32], float (&t)[32], Frag&& frag,
                                            uint32_t b_hi, uint32_t b_lo) {
  zero(t);
  product<TR>(t, frag, b_hi, b_lo);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += t[i];
}

// The f32 block: KB = 64 keys (kt) of one (batch, head) bh and slab z of SL
// output columns; it walks the 64-row query tiles, skipping those wholly
// before a causal key tile, with dk^T and dv^T in the consumers'
// registers, and (DQ) adds each query tile's dq = ds k into dq in key-tile
// order (the ordered sum, flash_attention.cuh) through the writer.  Per query
// tile, every product in three TF32 passes (flash_attention_sm90.cuh):
//   s^T = k q^T, dp^T = v dout^T   over 32-column chunks of the head dim;
//                    A = k (from k^T, or CHUNKED the slot's k), v: split in
//                    registers; B = q, dout (hi | lo)
//   p^T, ds^T        in the accumulators (p_ds2), then each to P (hi | lo)
//   dv^T += dout^T p, dk^T += q^T ds     A = dout^T, q^T read transposed
//                    from the slot (CHUNKED: the product slot, split);
//                    B = P
//   dq = ds k        (DQ) A = ds read transposed from P; B = k^T (hi | lo)
// dq goes to a dq tile in shared memory, which the writer adds into dq.
template <int D, bool CHUNKED, bool DQ>
__device__ __forceinline__ void bwd_tf32_body(const TmaArgs& p, int kt, int bh, int z) {
  using L = BwdF32Smem<D, CHUNKED, DQ>;
  constexpr int KB = L::KB, QT = L::QT, SL = L::SL, CH = L::CH, ST = L::STAGES;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  unsigned char* sp = smem_1024(flash_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t full = su + L::BARS, ready = full + 8 * ST, empty = ready + 8 * ST;
  const uint32_t res_full = empty + 8 * ST, res_ready = res_full + 8;
  const uint32_t dq_full = res_ready + 8, dq_free = dq_full + 8 * L::NDQ;
  const BwdArgs& a = p.a;
  const int tid = threadIdx.x, lane = tid & 31;
  // ld: the row length of the head dim; below D = 128 it may be 32 (D = 64's
  // columns past it come in as zeros and their products are skipped)
  const int ld = a.ld, col0 = z * SL, k0 = kt * KB;
  const int chunks = CHUNKED ? ld / CH : 1;   // score slots of a query tile
  auto slot = [&](int s) { return L::RING + s * L::SLOT; };
  auto aux = [&](int s) { return reinterpret_cast<float*>(sp + L::AUX0 + s * L::AUX); };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, L::PREP);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(res_full, 1);
    mbar_init(res_ready, L::PREP);
    for (int b = 0; b < L::NDQ; ++b) {
      mbar_init(dq_full + 8 * b, WG_THREADS);
      mbar_init(dq_free + 8 * b, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_THREADS) {
    // ---------------------------------------------------------- producer
    const int pw = tid - WG_THREADS;
    if (pw == 0) {
      // the TMA loads: k (into P, for prep) and v of the key tile, then
      // every slot in the consumers' order
      if constexpr (L::KT_RES) {
        mbar_expect_tx(res_full, KB * SL * 4 + L::V);
        tma_f32<SL, KB>(su + L::P_HI, &p.k, res_full, col0, k0, bh);
        if constexpr (!CHUNKED) tma_f32<D, KB>(su + L::V_RES, &p.v, res_full, 0, k0, bh);
      } else {
        mbar_arrive(res_full);
      }
      int it = 0;
      for (int qt = 0; qt < a.n_qt; ++qt) {
        const int q0 = qt * QT;
        if (skipped(a, q0, QT, k0)) continue;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          const uint32_t st = su + slot(s), bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * L::TC + (CHUNKED ? 2 * KB * CH * 4 : 0));
          tma_f32<CH, QT>(st + L::Q_HI, &p.q, bar, c * CH, q0, bh);
          tma_f32<CH, QT>(st + L::O_HI, &p.dout, bar, c * CH, q0, bh);
          if constexpr (CHUNKED) {
            tma_f32<CH, KB>(st + L::K_IN, &p.k, bar, c * CH, k0, bh);
            tma_f32<CH, KB>(st + L::V_IN, &p.v, bar, c * CH, k0, bh);
          }
        }
        if constexpr (CHUNKED) {
          const int s = it % ST;
          const uint32_t st = su + slot(s), bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * QT * SL * 4);
          tma_f32<SL, QT>(st + L::P_Q, &p.q, bar, col0, q0, bh);
          tma_f32<SL, QT>(st + L::P_O, &p.dout, bar, col0, q0, bh);
          ++it;
        }
      }
    } else if (pw == 32) {
      if constexpr (DQ) {
        // the writer: each query tile's dq tile added into dq in key-tile
        // order (the ordered sum), by TMA reduce-add
        int n = 0;
        for (int qt = 0; qt < a.n_qt; ++qt) {
          if (skipped(a, qt * QT, QT, k0)) continue;
          const int b = n % L::NDQ;
          mbar_wait(dq_full + 8 * b, (n / L::NDQ) & 1);
          int* flag = dq_flag(a, bh, z, qt);
          flag_wait(flag, kt);
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
          for (int x = 0; x < SL / 32; ++x)
            if (col0 + 32 * x < ld)
              tma_add_box(&p.dq, su + L::DQB + b * L::DQT + x * QT * 128, col0 + 32 * x,
                          qt * QT, bh);
          tma_adds_commit();
          tma_adds_done();
          st_release(flag, kt + 1);
          mbar_arrive(dq_free + 8 * b);
          ++n;
        }
      }
    } else if (pw >= 64) {
      // prep: k^T (hi | lo) from k, then each slot's q and dout split in
      // place (score slots) and the query tile's lse log2(e), delta scale
      const int pt = pw - 64;
      mbar_wait(res_full, 0);
      if constexpr (L::KT_RES)
        transpose_split<KB, SL, false>(sp + L::P_HI, sp + L::KT_HI, sp + L::KT_LO, pt, L::PREP);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(res_ready);
      int it = 0;
      for (int qt = 0; qt < a.n_qt; ++qt) {
        const int q0 = qt * QT;
        if (skipped(a, q0, QT, k0)) continue;
        const float2 row = row_terms(a, bh, q0 + pt);
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % ST;
          unsigned char* st = sp + slot(s);
          mbar_wait(full + 8 * s, (it / ST) & 1);
          split_in_place(st + L::Q_HI, st + L::Q_LO, L::TC, pt, L::PREP);
          split_in_place(st + L::O_HI, st + L::O_LO, L::TC, pt, L::PREP);
          aux(s)[pt] = row.x;
          aux(s)[QT + pt] = row.y;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ready + 8 * s);
        }
        if constexpr (CHUNKED) {
          // the product slot is used as loaded
          const int s = it % ST;
          mbar_wait(full + 8 * s, (it / ST) & 1);
          mbar_arrive(ready + 8 * s);
          ++it;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wq = tid / 32, g = lane >> 2, t = lane & 3;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.heads) * a.tk : nullptr;
  const int r0 = 16 * wq + g;                  // this thread's first row of an M = 64 tile
  // The visibility of key k0 + r of the block to query column c of the tile
  // at q0: seen where c >= min(QT, seen_from[r] - q0) (causal; non-causal
  // seen_from[r] - 0), seen_from huge for a key past Tk or masked; and every
  // entry of warp w's 16 keys is seen (no per-entry rule) where q0 >=
  // exact_from[w].  Kept in shared memory: read once a tile, they would
  // otherwise hold registers the products need.
  int* seen_from = reinterpret_cast<int*>(sp + L::VIS0);
  int* exact_from = seen_from + KB;
  bool all_ok = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kg = k0 + r0 + 8 * h;
    const bool ok = kg < a.tk && (km == nullptr || km[kg] > 0.f);
    if (t == 0) seen_from[r0 + 8 * h] = ok ? (a.causal ? kg + a.k_offset - a.q_offset : 0) : 1 << 30;
    all_ok = all_ok && ok;
  }
  all_ok = __all_sync(0xffffffffu, all_ok);
  if (lane == 0)
    exact_from[wq] = !all_ok ? 1 << 30
                     : a.causal ? k0 + 16 * wq + 15 + a.k_offset - a.q_offset : -(1 << 30);
  __syncwarp();
  const float sl2 = a.scale * LOG2E;
  float dk[32], dv[32];   // dk^T, dv^T: columns col0 + r0 + 8 h, keys 8 j + 2 t + e
  zero(dk);
  zero(dv);
  mbar_wait(res_ready, 0);
  int it = 0, n = 0;      // n: dq tiles handed to the writer
  for (int qt = 0; qt < a.n_qt; ++qt) {
    const int q0 = qt * QT;
    if (skipped(a, q0, QT, k0)) continue;
    // s^T = k q^T and dp^T = v dout^T: keys k0 + r0 + 8 h, queries 8 j + 2 t + e
    // (k and v by plain shared loads: ldmatrix, as the forward reads q, made
    // ptxas spill here)
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    int s = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      s = it % ST;
      const int sl = slot(s);
      mbar_wait(ready + 8 * s, (it / ST) & 1);
#pragma unroll
      for (int c2 = 0; c2 < CH && c2 < ld; c2 += 32) {
        uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (CHUNKED)
            a_split<KB, false>(kh[kk], kl[kk], sp + sl + L::K_IN, r0, c2 + 8 * kk + t);
          else
            a_pair<SL, true>(kh[kk], kl[kk], sp + L::KT_HI, L::KT, r0, c2 + 8 * kk + t);
        }
        reg_fence(st);
        reg_fence(dpt);
        reg_fence(kh);
        reg_fence(kl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(st, kh[kk], kl[kk], desc_f32<QT>(su + sl + L::Q_HI, c2 + 8 * kk),
               desc_f32<QT>(su + sl + L::Q_LO, c2 + 8 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          a_split<KB, false>(vh[kk], vl[kk], sp + (CHUNKED ? sl + L::V_IN : L::V_RES), r0,
                             c2 + 8 * kk + t);
        reg_fence(vh);
        reg_fence(vl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(dpt, vh[kk], vl[kk], desc_f32<QT>(su + sl + L::O_HI, c2 + 8 * kk),
               desc_f32<QT>(su + sl + L::O_LO, c2 + 8 * kk));
        wg_commit();
        wg_wait();
        reg_fence(st);
        reg_fence(dpt);
        reg_fence(kh);
        reg_fence(kl);
        reg_fence(vh);
        reg_fence(vl);
      }
      // the last score slot stays until p and ds are made from its aux (and,
      // below D = 128, until its q and dout have served dv^T and dk^T)
      if (c + 1 < chunks) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // p^T and ds^T in place (entry 4 j + e: key h = e >> 1, query column
    // 8 j + 2 t + (e & 1))
    const float* rows = aux(s);
    int from[2];                    // entry 4 j + e is seen where 8 j + (e & 1) >= from[h]
    const bool exact = q0 >= exact_from[wq];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      from[h] = exact ? -QT : min(QT, seen_from[r0 + 8 * h] - (a.causal ? q0 : 0)) - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const float2 pd = p_ds2(st[4 * j + e], dpt[4 * j + e], make_float2(rows[ql], rows[QT + ql]),
                                sl2, a.scale, 8 * j + (e & 1) >= from[h]);
        st[4 * j + e] = pd.x;
        dpt[4 * j + e] = pd.y;
      }
    // the product operands: this query tile's dout and q, (hi | lo) in the
    // score slot below D = 128, as loaded in the product slot from D = 128 on
    int ps = s;
    if constexpr (CHUNKED) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      ps = it % ST;
      mbar_wait(ready + 8 * ps, (it / ST) & 1);
      ++it;
    }
    const unsigned char* pq = sp + slot(ps) + (CHUNKED ? L::P_Q : L::Q_HI);
    const unsigned char* po = sp + slot(ps) + (CHUNKED ? L::P_O : L::O_HI);
    // A = x^T over the query tile (x: q or dout; rows r0 + 8 h of its SL
    // columns), read transposed from the slot
    auto xt = [&](const unsigned char* x) {
      return [=](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        if constexpr (CHUNKED)
          a_split<QT, true>(hi, lo, x, r0, 8 * kk + t);
        else
          a_pair<QT, true>(hi, lo, x, L::TC, r0, 8 * kk + t);
      };
    };
    float tile[32];                // a product's fresh accumulator (add_product)

    // dv^T += dout^T p: B = p^T from P, once the last tile's readers of P
    // are done
    consumer_wg_sync();
    to_p(sp + L::P_HI, sp + L::P_LO, st, r0, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_wg_sync();
    add_product(dv, tile, xt(po), su + L::P_HI, su + L::P_LO);

    // dk^T += q^T ds: the same with q and ds^T
    to_p(sp + L::P_HI, sp + L::P_LO, dpt, r0, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_wg_sync();
    add_product(dk, tile, xt(pq), su + L::P_HI, su + L::P_LO);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ps);   // the slot's q and dout are read
    if constexpr (DQ) {
      // dq = ds k: A (queries r0 + 8 h, keys) read transposed from P; B = k^T
      float dq[SL / 2];     // queries r0 + 8 h, columns col0 + 8 j + 2 t + e
      zero(dq);
      product<SL>(dq, [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        a_pair<KB, true>(hi, lo, sp + L::P_HI, L::PT, r0, 8 * kk + t);
      }, su + L::KT_HI, su + L::KT_LO);

      // to the writer, in the dq tile's swizzled boxes of 32 columns
      const int b = n % L::NDQ;
      mbar_wait(dq_free + 8 * b, ((n / L::NDQ) & 1) ^ 1);
      unsigned char* dq_tile = sp + L::DQB + b * L::DQT;
#pragma unroll
      for (int j = 0; j < SL / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(dq_tile + f32_at<QT>(r0 + 8 * h, 8 * j + 2 * t)) =
              make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(dq_full + 8 * b);
      ++n;
    }
  }

  // dk, dv: key kg, column col0 + d from dk^T, dv^T
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = r0 + 8 * h;
    if (d >= SL || col0 + d >= ld) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        if (key >= a.tk) continue;
        const size_t i = ((size_t)bh * a.tk + key) * ld + col0 + d;
        a.dk[i] = dk[4 * j + 2 * h + e];
        a.dv[i] = dv[4 * j + 2 * h + e];
      }
  }
}

// ------------------------------------------------------------------ host
// A 3-D map over [BH, rows, ld] bf16 (innermost first), boxes of 64 rows x
// BX columns, swizzled for wgmma; rows past `rows` read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int bh, int rows, int ld) {
  const int bx = ld < 64 ? ld : 64;
  cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)rows * ld * 2};
  cuuint32_t box[3] = {(cuuint32_t)bx, (cuuint32_t)TR, 1};
  cuuint32_t one[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                bx == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q, k, v and dout (and, for the merged backward, dq) beside the
// arguments; cudaErrorInvalidValue when the CUDA driver refuses one.
inline int tma_args(TmaArgs& p, const BwdArgs& a, bool merged) {
  p.a = a;
  const bool ok = encode_map(&p.q, a.q, a.bh, a.tq, a.ld) &&
                  encode_map(&p.k, a.k, a.bh, a.tk, a.ld) &&
                  encode_map(&p.v, a.v, a.bh, a.tk, a.ld) &&
                  encode_map(&p.dout, a.dout, a.bh, a.tq, a.ld) &&
                  (!merged || encode_f32_map(&p.dq, a.dq, a.bh, a.tq, a.ld));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
