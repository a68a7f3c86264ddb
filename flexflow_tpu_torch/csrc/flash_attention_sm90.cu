// Flash attention forward (K5), backward dq (K6), dk/dv (K7) and the
// fused single-tile backward (K8) for Hopper, bf16 at head_dim 64 and 128:
// TMA tensor loads into 128-byte-swizzled shared memory, mbarrier rings
// between one producer warp and two consumer warpgroups, and
// wgmma.mma_async products. `csrc/flash_attention.cu` keeps the mma.sync
// (bf16) and SIMT (f32) versions of all four for every other shape.
//
// Replaces the TPU kernels (flexflow_tpu/kernels/flash_attention.py)
//   _flash_kernel_grouped (705), pallas_call at 946, and _flash_kernel
//     (117), pallas_call at 253 and 1002                            -> K5
//   _bwd_dq_kernel_grouped (808), pallas_call at 1045, and
//     _bwd_dq_kernel (351), pallas_call at 546 and 1145             -> K6
//   _bwd_dkv_kernel_grouped (854), pallas_call at 1064, and
//     _bwd_dkv_kernel (392), pallas_call at 563 and 1164            -> K7
//   _bwd_single_tile_kernel (442), pallas_call at 483 and 1120      -> K8
// reached from flash_attention_packed (1212), flash_attention (1608) and
// flash_attention_with_lse (657) through their custom VJPs.
//
// What they compute is K5-K8's function in csrc/flash_attention.cu, with
// the same masks (-1e30, causal offset s_k - s_q), the same rounding
// points (P and dS rounded to bf16 before each product, against the
// running row max in K5) and one cast per output; only the order of the
// sums differs, and the exponentials run as exp2 on logits pre-scaled by
// scale * log2(e) (lse is stored in natural log).
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s). lm-xxl-fsdp (b 4, 32
// heads of 128, s 2048, causal): tensor-core work, 68.8 GFLOP a product;
// K5 two products, 139 us (bytes 80 us); K6 three, 209 us (bytes 101 us);
// K7 four, 278 us (bytes 121 us). lm-base (b 8, 16 heads of 64, s 512,
// causal): bytes, K5 10.1 us, K6 12.7 us, K7 15.2 us, K8 17.7 us (q, k, v,
// dO, lse, delta in; dq, dk, dv out), against 2.8-10.9 us of tensor-core
// work. K8 at (2, 512, 8 heads of 128) packed: bytes, 4.4 us.
//
// Design. A block has 384 threads: warpgroup 0 is the producer (one
// thread issues every copy; setmaxnreg gives its registers away, 40 a
// thread), warpgroups 1 and 2 the consumers (232 a thread), each owning
// 64 rows of the block's 128 (query rows in K5 and K6, keys in K7 and
// K8). The copies are TMA loads of 64-column boxes (128 bytes, the
// swizzle's width; a head_dim-128 tile is two boxes) through one 4-D
// tensor map per operand that reads either layout where it lies: (d, h,
// s, b) for the packed (b, s, h*d) projections, (d, s, h, b) for (b, h, s,
// d). Rows past the sequence come back as zeros. The streamed operand
// rides a two-stage ring; each stage has a full mbarrier (the producer's
// expected bytes) and an empty one (every consumer thread arrives once its
// products have read the stage).
//
// K5: one block per (b, h, 128 query rows), longest causal rows first. Q
// is loaded once; K and V stream in 128-key stages (Q 32 KB + 2 x 64 KB
// at head_dim 128). Per stage and consumer: S = Q K^T as wgmma m64n128k16
// from shared memory (both K-major), the online softmax in registers over
// the two rows a thread holds (masks only on tiles that cross the causal
// diagonal or the sequence end), then O += round(P) V with P as the
// register A operand (the f32 accumulator fragment of S is, rounded, the
// A fragment of P) and V as the MN-major B operand. Epilogue: out = O / l,
// lse = (m + log2 l) ln 2.
//
// K6: K5's skeleton. One block per (b, h, 128 query rows), longest causal
// rows first; Q and dO are loaded once, each consumer keeps its rows' lse
// and delta in registers (plain loads), and K and V stream in 64-key
// stages (at head_dim 128, S and dP of 128 keys beside dQ would pass the
// 232 registers a consumer has). Per stage and consumer: S = Q K^T and dP
// = dO V^T as wgmma m64n64k16 from shared memory, P = exp2(S c - lse
// log2 e) (0 where masked) and dS = P (dP - delta) scale in registers,
// then dQ += round(dS) K with dS as the register A operand and K as the
// MN-major B operand. dQ is cast once.
//
// K7: one block per (b, h, 128 keys); K and V stay in shared memory (64
// KB at head_dim 128). Q, dO and their lse and delta rows stream in
// 64-row stages from the causal diagonal down (the f32 rows copied by the
// producer warp's 32 lanes, whose arrivals join the stage's full
// barrier: a row's start need not be 16-byte aligned, as TMA's must).
// Per stage and consumer, on the transposed tiles: S^T = K Q^T and dP^T =
// V dO^T as wgmma m64n64k16 from shared memory, then P^T = exp2(...) (0
// where masked) and dS^T = P^T (dP^T - delta) scale in registers, then
// dV += round(P^T) dO and dK += round(dS^T) Q with the rounded tiles as
// register A operands and dO, Q as MN-major B operands.
// dK and dV (2 x 64 f32 a thread at head_dim 128) stay in registers and
// are cast once; each has one writer, no atomics.
//
// K8: K7's blocks, with dQ. The JAX package runs it where the sequence
// fits one 512-row block, so a (b, h) has at most 4 blocks of 128 keys
// (under the portable cluster size of 8); they form one thread-block
// cluster (the grid's x) and walk the same 64-row q stages in lockstep,
// from the last stage up, so that a block's live stages (those with a
// row that sees one of its keys) come first. Per stage each consumer also
// writes round(dS) to shared memory in (q, key) order; after a barrier
// over both consumers, the block's dQ partial, round(dS) K over its 128
// keys, is a wgmma m64n64 with both operands in shared memory (dS
// K-major, K MN-major; at head_dim 128 each consumer takes 64 columns, at
// 64 the first takes all), stored as f32 into one of two staging slots.
// Each block then arrives (remotely) on an mbarrier of rank 0, whose
// producer warpgroup's three spare warps read the live blocks' partials
// through distributed shared memory, sum them in rank order in f32, cast
// the 64 dq rows once and store them, then arrive on each of those
// blocks' "slot free" mbarrier, which a block waits on before it writes
// that slot again, and before it leaves. A block leaves after its live
// stages, so a GPC can start the next cluster on the SMs of the blocks
// with fewer causal stages. No dq row outlives its stage and there is no
// global scratch; the sums run in a fixed order, so results are the same
// bits from run to run (no atomics).
//
// Later work: ping-pong between the two consumer warpgroups, and
// overlapping one tile's softmax with the next tile's products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 384;    // producer warpgroup + two consumers
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kBlockRows = 128;  // K5: query rows a block; K7: keys
constexpr int kKvRows = 128;     // K5: keys a stage
constexpr int kQRows = 64;       // K7: query rows a stage
constexpr int kStages = 2;
constexpr int kBox = 64;  // bf16 columns of one 128-byte swizzled box

// Element strides of the two tensor groups: q, out, dO (q*) and k, v, dk,
// dv (k*), by batch, head and row.
struct Strides {
  long long qb, qh, qr;
  long long kb, kh, kr;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also sets the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ROWS rows of head h of batch b from `row` on, all HD columns: HD / 64
// boxes, each ROWS x 128 bytes (swizzled) one after another. row_axis is
// the map's row dimension (1 or 2); the head is the other one.
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row_axis, int row,
                                         int h, int b) {
  const int c1 = row_axis == 1 ? row : h;
  const int c2 = row_axis == 1 ? h : row;
#pragma unroll
  for (int half = 0; half < HD / kBox; ++half)
    tma_load_4d(dst + half * ROWS * 128, map, bar, half * kBox, c1, c2, b);
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The registers an asynchronous product writes (accumulators) or reads (A
// fragments) are the compiler's to move only after the wait: these empty
// asm statements pin every use on the right side of it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes, 8-row atoms of 1024
// bytes, every tile 1024-byte aligned): start, leading and stride byte
// offsets, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand rows [row0, row0 + 64 or N) of a tile stored as HD/64
// boxes of ROWS x 64; k step kk covers columns 16 kk .. 16 kk + 15 (32
// bytes into a 128-byte row of box kk / 4).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int row0,
                                           int kk) {
  return gmma_desc(tile + (kk >> 2) * ROWS * 128 + row0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major B operand of a tile of ROWS x HD stored as boxes: k runs down
// the rows (k step kk = rows 16 kk .. 16 kk + 15, two 8-row atoms), n along
// the head dim (the next 64 columns one box, ROWS x 128 bytes, on).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

// d (+)= a . b for one k step of 16: m64nNk16, bf16 operands, f32
// accumulators. _ss: a and b from shared memory (K-major; `accumulate` 0
// overwrites d). _rs: a from registers (an A fragment: rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each warp's 16 rows, as
// mma.m16n8k16's), b MN-major from shared memory, accumulating.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= a . b, a K-major and b MN-major, both from shared memory: the
// shared-memory A operand of K8's dQ = round(dS) K over 64 head columns
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// two floats rounded to bf16 (to nearest even, as torch's cast), packed
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments (m64nN, f32): in warp w of the warpgroup, with
// g = lane / 4 and t = lane % 4, element i sits at row 16 w + g + 8 (i % 4
// >= 2) and column 8 (i / 4) + 2 t + i % 2. Rounded and packed two 8-column
// chunks at a time they are the A fragments of the next product.
template <int K16>
__device__ __forceinline__ void to_a(uint32_t (&a)[K16][4],
                                     const float (&s)[K16 * 8]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// over the four lanes that hold one row of a fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// K8's split: its producer warpgroup also sums dq (eight remote reads in
// flight a thread), so it keeps 56 and each consumer takes 224
__device__ __forceinline__ void fused_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}

__device__ __forceinline__ void fused_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

// the n threads of a named barrier (id > 0; 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// shared memory that threads wrote, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ clusters

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the address of this shared-memory address in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// one arrival on an mbarrier of any block of the cluster (a mapped
// address), releasing this thread's earlier memory operations
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait, acquiring what the other blocks' arrivals released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ============================================================ K5

template <int HD>
struct FwdSmem {
  static constexpr uint32_t kTileQ = kBlockRows * HD * 2;
  static constexpr uint32_t kTileKV = kKvRows * HD * 2;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kTileQ;
  static constexpr size_t v = k + kStages * kTileKV;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr size_t bars = v + kStages * kTileKV;
  static constexpr size_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               bf16* __restrict__ out, float* __restrict__ lse, int heads,
               int s_q, int s_k, float scale, int causal, int q_axis,
               int k_axis, Strides st) {
  using L = FwdSmem<HD>;
  extern __shared__ uint8_t ff_raw[];
  uint8_t* smem = aligned_smem(ff_raw);
  uint8_t* sq = smem + L::q;
  uint8_t* sk = smem + L::k;
  uint8_t* sv = smem + L::v;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int nq = (s_q + kBlockRows - 1) / kBlockRows;
  const int i0 = (nq - 1 - blockIdx.x) * kBlockRows;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = s_k - s_q;  // causal offset, >= 0 (the wrapper's contract)
  const int kv_end = causal ? min(s_k, i0 + kBlockRows + off) : s_k;
  const int nkv = (kv_end + kKvRows - 1) / kKvRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTileQ);
      tma_tile<HD, kBlockRows>(sq, &tq, q_full, q_axis, i0, h, b);
      for (int jt = 0; jt < nkv; ++jt) {
        const int s = jt % kStages;
        mbar_wait(&empty[s], ((jt / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::kTileKV);
        tma_tile<HD, kKvRows>(sk + s * L::kTileKV, &tk, &k_full[s], k_axis,
                              jt * kKvRows, h, b);
        mbar_expect_tx(&v_full[s], L::kTileKV);
        tma_tile<HD, kKvRows>(sv + s * L::kTileKV, &tv, &v_full[s], k_axis,
                              jt * kKvRows, h, b);
      }
    }
  } else {  // consumers: 64 query rows each
    consumer_regs();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int r0 = i0 + 64 * w;
    const int r_lo = r0 + warp * 16 + (lane >> 2);  // this thread's two rows
    const int r_hi = r_lo + 8;
    const float sl2 = scale * kLog2e;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
    float l_lo = 0.f, l_hi = 0.f;

    mbar_wait(q_full, 0);
    for (int jt = 0; jt < nkv; ++jt) {
      const int s = jt % kStages;
      const int ph = (jt / kStages) & 1;
      const uint8_t* kt = sk + s * L::kTileKV;
      const uint8_t* vt = sv + s * L::kTileKV;
      mbar_wait(&k_full[s], ph);
      float sc[64];  // S: 64 rows x 128 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n128(sc, desc_k<kBlockRows>(sq, 64 * w, kk),
                      desc_k<kKvRows>(kt, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      pin(sc);

      const int j0 = jt * kKvRows;
      // only tiles that cross the causal diagonal or the sequence end
      const bool masked =
          j0 + kKvRows > s_k || (causal && j0 + kKvRows - 1 > r0 + off);
      float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const bool hi = (i & 3) >= 2;
        float x = sc[i] * sl2;
        if (masked) {
          const int col = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = hi ? r_hi : r_lo;
          if (col >= s_k || (causal && col > row + off)) x = kNegInf;
        }
        sc[i] = x;
        if (hi) {
          mx_hi = fmaxf(mx_hi, x);
        } else {
          mx_lo = fmaxf(mx_lo, x);
        }
      }
      // finite: key 0 of the first tile is live for every row it serves
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i & 3) >= 2) {
          sc[i] = exp2f(sc[i] - mn_hi);
          sum_hi += sc[i];
        } else {
          sc[i] = exp2f(sc[i] - mn_lo);
          sum_lo += sc[i];
        }
      }
      const float a_lo = exp2f(m_lo - mn_lo);  // m = -inf (first tile) -> 0
      const float a_hi = exp2f(m_hi - mn_hi);
      l_lo = l_lo * a_lo + quad_sum(sum_lo);
      l_hi = l_hi * a_hi + quad_sum(sum_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 3) >= 2 ? a_hi : a_lo;
      uint32_t pa[kKvRows / 16][4];
      to_a<kKvRows / 16>(pa, sc);

      mbar_wait(&v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvRows / 16; ++kk)
        wgmma_rs<HD>(o, pa[kk], desc_mn<kKvRows>(vt, kk));  // O += P V
      wgmma_commit();
      wgmma_wait();
      pin(o);
      pin(pa);
      mbar_arrive(&empty[s]);
    }

    const long long qrow0 = b * st.qb + h * st.qh;
    const float inv_lo = 1.f / l_lo;
    const float inv_hi = 1.f / l_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (r_lo < s_q)
        *reinterpret_cast<__nv_bfloat162*>(out + qrow0 + r_lo * st.qr + col) =
            __floats2bfloat162_rn(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
      if (r_hi < s_q)
        *reinterpret_cast<__nv_bfloat162*>(out + qrow0 + r_hi * st.qr + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv_hi,
                                  o[4 * n + 3] * inv_hi);
    }
    if (t == 0) {
      const long long stat = ((long long)b * heads + h) * s_q;
      if (r_lo < s_q) lse[stat + r_lo] = (m_lo + log2f(l_lo)) * kLn2;
      if (r_hi < s_q) lse[stat + r_hi] = (m_hi + log2f(l_hi)) * kLn2;
    }
  }
}

// ============================================================ K7

template <int HD>
struct DkvSmem {
  static constexpr uint32_t kTileKV = kBlockRows * HD * 2;
  static constexpr uint32_t kTileQ = kQRows * HD * 2;
  static constexpr uint32_t kRowBytes = kQRows * 4;  // one f32 row stat
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kTileKV;
  static constexpr size_t q = v + kTileKV;
  static constexpr size_t dout = q + kStages * kTileQ;
  static constexpr size_t lse = dout + kStages * kTileQ;
  static constexpr size_t delta = lse + kStages * kRowBytes;
  // kv_full, full[kStages], empty[kStages]
  static constexpr size_t bars = delta + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int heads, int s_q, int s_k,
                   float scale, int causal, int q_axis, int k_axis,
                   Strides st) {
  using L = DkvSmem<HD>;
  extern __shared__ uint8_t ff_raw[];
  uint8_t* smem = aligned_smem(ff_raw);
  uint8_t* sk = smem + L::k;
  uint8_t* sv = smem + L::v;
  uint8_t* sq = smem + L::q;
  uint8_t* sdo = smem + L::dout;
  float* slse = reinterpret_cast<float*>(smem + L::lse);
  float* sdl = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int j0 = blockIdx.x * kBlockRows;  // the first key tiles see most rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = s_k - s_q;
  // the first q tile with a row that sees key j0 under the causal mask
  const int first = (causal ? max(0, j0 - off) : 0) / kQRows;
  const int nq = (s_q + kQRows - 1) / kQRows;
  const int stat = (b * heads + h) * s_q;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the loads' expected bytes, 32 lanes
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0; lane 0 issues the tensor loads
    producer_regs();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kTileKV);
        tma_tile<HD, kBlockRows>(sk, &tk, kv_full, k_axis, j0, h, b);
        tma_tile<HD, kBlockRows>(sv, &tv, kv_full, k_axis, j0, h, b);
      }
      for (int it = first; it < nq; ++it) {
        const int n = it - first;
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::kTileQ);
          tma_tile<HD, kQRows>(sq + s * L::kTileQ, &tq, &full[s], q_axis,
                               it * kQRows, h, b);
          tma_tile<HD, kQRows>(sdo + s * L::kTileQ, &tdo, &full[s], q_axis,
                               it * kQRows, h, b);
        }
        for (int r = lane; r < kQRows; r += 32) {
          const int row = it * kQRows + r;
          slse[s * kQRows + r] = row < s_q ? lse[stat + row] : 0.f;
          sdl[s * kQRows + r] = row < s_q ? delta[stat + row] : 0.f;
        }
        mbar_arrive(&full[s]);  // releases this lane's rows
      }
    }
  } else {  // consumers: 64 keys each
    consumer_regs();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int kw0 = j0 + 64 * w;
    const int k_lo = kw0 + warp * 16 + (lane >> 2);  // this thread's two keys
    const int k_hi = k_lo + 8;
    const float sl2 = scale * kLog2e;
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      acc_k[i] = 0.f;
      acc_v[i] = 0.f;
    }

    mbar_wait(kv_full, 0);
    for (int it = first; it < nq; ++it) {
      const int n = it - first;
      const int s = n % kStages;
      const uint8_t* qt = sq + s * L::kTileQ;
      const uint8_t* dot = sdo + s * L::kTileQ;
      const float* tl = slse + s * kQRows;
      const float* td = sdl + s * kQRows;
      mbar_wait(&full[s], (n / kStages) & 1);
      float sct[32], dpt[32];  // S^T, dP^T: 64 keys x 64 query rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sct, desc_k<kBlockRows>(sk, 64 * w, kk),
                     desc_k<kQRows>(qt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k<kBlockRows>(sv, 64 * w, kk),
                     desc_k<kQRows>(dot, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      pin(sct);
      pin(dpt);

      const int i0 = it * kQRows;
      const bool masked = i0 + kQRows > s_q || kw0 + 64 > s_k ||
                          (causal && i0 + off < kw0 + 63);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1);  // query row in tile
        const int key = (i & 3) >= 2 ? k_hi : k_lo;
        float p = exp2f(sct[i] * sl2 - tl[r] * kLog2e);
        // padded q rows and keys are masked out of p (mask_q_rows)
        if (masked && !(i0 + r < s_q && key < s_k &&
                        (!causal || i0 + r + off >= key)))
          p = 0.f;
        sct[i] = p;
        dpt[i] = p * (dpt[i] - td[r]) * scale;  // dS^T
      }
      uint32_t pa[kQRows / 16][4], da[kQRows / 16][4];
      to_a<kQRows / 16>(pa, sct);
      to_a<kQRows / 16>(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs<HD>(acc_v, pa[kk], desc_mn<kQRows>(dot, kk));  // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs<HD>(acc_k, da[kk], desc_mn<kQRows>(qt, kk));  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait();
      pin(acc_v);
      pin(acc_k);
      pin(pa);
      pin(da);
      mbar_arrive(&empty[s]);
    }

    const long long krow0 = b * st.kb + h * st.kh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (k_lo < s_k) {
        const long long o = krow0 + k_lo * st.kr + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[4 * n], acc_k[4 * n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[4 * n], acc_v[4 * n + 1]);
      }
      if (k_hi < s_k) {
        const long long o = krow0 + k_hi * st.kr + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[4 * n + 2], acc_k[4 * n + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[4 * n + 2], acc_v[4 * n + 3]);
      }
    }
  }
}

// ============================================================ K6

constexpr int kDqKvRows = 64;  // K6: keys a stage

template <int HD>
struct DqSmem {
  static constexpr uint32_t kTileQ = kBlockRows * HD * 2;
  static constexpr uint32_t kTileKV = kDqKvRows * HD * 2;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + kTileQ;
  static constexpr size_t k = dout + kTileQ;
  static constexpr size_t v = k + kStages * kTileKV;
  // q_full (q and dO), full[kStages] (k and v), empty[kStages]
  static constexpr size_t bars = v + kStages * kTileKV;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int heads, int s_q, int s_k, float scale, int causal,
                  int q_axis, int k_axis, Strides st) {
  using L = DqSmem<HD>;
  extern __shared__ uint8_t ff_raw[];
  uint8_t* smem = aligned_smem(ff_raw);
  uint8_t* sq = smem + L::q;
  uint8_t* sdo = smem + L::dout;
  uint8_t* sk = smem + L::k;
  uint8_t* sv = smem + L::v;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nq = (s_q + kBlockRows - 1) / kBlockRows;
  const int i0 = (nq - 1 - blockIdx.x) * kBlockRows;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = s_k - s_q;
  const int kv_end = causal ? min(s_k, i0 + kBlockRows + off) : s_k;
  const int nkv = (kv_end + kDqKvRows - 1) / kDqKvRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    producer_regs();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kTileQ);
      tma_tile<HD, kBlockRows>(sq, &tq, q_full, q_axis, i0, h, b);
      tma_tile<HD, kBlockRows>(sdo, &tdo, q_full, q_axis, i0, h, b);
      for (int jt = 0; jt < nkv; ++jt) {
        const int s = jt % kStages;
        mbar_wait(&empty[s], ((jt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kTileKV);
        tma_tile<HD, kDqKvRows>(sk + s * L::kTileKV, &tk, &full[s], k_axis,
                                jt * kDqKvRows, h, b);
        tma_tile<HD, kDqKvRows>(sv + s * L::kTileKV, &tv, &full[s], k_axis,
                                jt * kDqKvRows, h, b);
      }
    }
  } else {  // consumers: 64 query rows each
    consumer_regs();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int r0 = i0 + 64 * w;
    const int r_lo = r0 + warp * 16 + (lane >> 2);  // this thread's two rows
    const int r_hi = r_lo + 8;
    const float sl2 = scale * kLog2e;
    // a row's lse and delta by plain loads: its start need not be 16-byte
    // aligned, as a TMA source must
    const long long stat = ((long long)b * heads + h) * s_q;
    const float ll_lo = r_lo < s_q ? lse[stat + r_lo] * kLog2e : 0.f;
    const float ll_hi = r_hi < s_q ? lse[stat + r_hi] * kLog2e : 0.f;
    const float dl_lo = r_lo < s_q ? delta[stat + r_lo] : 0.f;
    const float dl_hi = r_hi < s_q ? delta[stat + r_hi] : 0.f;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int jt = 0; jt < nkv; ++jt) {
      const int s = jt % kStages;
      const uint8_t* kt = sk + s * L::kTileKV;
      const uint8_t* vt = sv + s * L::kTileKV;
      mbar_wait(&full[s], (jt / kStages) & 1);
      float sc[32], dp[32];  // S, dP: 64 rows x 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<kBlockRows>(sq, 64 * w, kk),
                     desc_k<kDqKvRows>(kt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<kBlockRows>(sdo, 64 * w, kk),
                     desc_k<kDqKvRows>(vt, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      pin(sc);
      pin(dp);

      const int j0 = jt * kDqKvRows;
      // only tiles that cross the causal diagonal or the sequence end
      const bool masked = j0 + kDqKvRows > s_k ||
                          (causal && j0 + kDqKvRows - 1 > r0 + off);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 3) >= 2;
        float p = exp2f(sc[i] * sl2 - (hi ? ll_hi : ll_lo));
        if (masked) {
          const int col = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = hi ? r_hi : r_lo;
          if (col >= s_k || (causal && col > row + off)) p = 0.f;
        }
        dp[i] = p * (dp[i] - (hi ? dl_hi : dl_lo)) * scale;  // dS
      }
      uint32_t da[kDqKvRows / 16][4];
      to_a<kDqKvRows / 16>(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKvRows / 16; ++kk)
        wgmma_rs<HD>(acc, da[kk], desc_mn<kDqKvRows>(kt, kk));  // dQ += dS K
      wgmma_commit();
      wgmma_wait();
      pin(acc);
      pin(da);
      mbar_arrive(&empty[s]);
    }

    const long long qrow0 = b * st.qb + h * st.qh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (r_lo < s_q)
        *reinterpret_cast<__nv_bfloat162*>(dq + qrow0 + r_lo * st.qr + col) =
            __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
      if (r_hi < s_q)
        *reinterpret_cast<__nv_bfloat162*>(dq + qrow0 + r_hi * st.qr + col) =
            __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

// ============================================================ K8

constexpr int kMaxCluster = 4;  // blocks of 128 keys: s_k <= 512

template <int HD>
struct FusedSmem {
  static constexpr uint32_t kTileKV = kBlockRows * HD * 2;
  static constexpr uint32_t kTileQ = kQRows * HD * 2;
  static constexpr uint32_t kTileDs = kQRows * kBlockRows * 2;
  static constexpr uint32_t kRowBytes = kQRows * 4;  // one f32 row stat
  static constexpr int kPartLd = HD + 8;  // f32 row stride of a dQ partial
  static constexpr uint32_t kPart = kQRows * kPartLd * 4;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kTileKV;
  static constexpr size_t q = v + kTileKV;
  static constexpr size_t dout = q + kStages * kTileQ;
  static constexpr size_t ds = dout + kStages * kTileQ;
  static constexpr size_t part = ds + kTileDs;  // two slots
  static constexpr size_t lse = part + 2 * kPart;
  static constexpr size_t delta = lse + kStages * kRowBytes;
  // kv_full, full[kStages], empty[kStages], part_full[2], part_free[2]
  static constexpr size_t bars = delta + kStages * kRowBytes;
  static constexpr size_t bytes = bars + 8 * (1 + 2 * kStages + 4) + 1024;
};

// byte offset of bf16 element (row, col) in a tile stored as 64-column
// boxes of `rows` rows, 128-byte swizzled as TMA stores them
__device__ __forceinline__ uint32_t swizzled(int row, int col, int rows) {
  const int c = (col & 63) * 2;
  return (col >> 6) * rows * 128 + row * 128 +
         ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
                     int s_q, int s_k, float scale, int causal, int q_axis,
                     int k_axis, Strides st) {
  using L = FusedSmem<HD>;
  extern __shared__ uint8_t ff_raw[];
  uint8_t* smem = aligned_smem(ff_raw);
  uint8_t* sk = smem + L::k;
  uint8_t* sv = smem + L::v;
  uint8_t* sq = smem + L::q;
  uint8_t* sdo = smem + L::dout;
  uint8_t* sds = smem + L::ds;
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* slse = reinterpret_cast<float*>(smem + L::lse);
  float* sdl = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* part_full = empty + kStages;
  uint64_t* part_free = part_full + 2;

  // the cluster spans the grid's x: block x holds keys 128 x on, and is
  // rank x of the cluster of its (b, h)
  const int rank = blockIdx.x;
  const int nk = gridDim.x;
  const int j0 = rank * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = s_k - s_q;
  // the first q stage with a row that sees key 128 r under the causal mask
  auto first_of = [&](int r) {
    return (causal ? max(0, r * kBlockRows - off) : 0) / kQRows;
  };
  const int nq = (s_q + kQRows - 1) / kQRows;
  // Every block walks the q stages from the last one up, in lockstep:
  // step n is stage nq - 1 - n, and this block's live stages (those with
  // a row that sees one of its keys) are its first `live` steps. Once
  // they are summed it leaves, and the GPC can start another cluster.
  const int live = nq - first_of(rank);
  // the blocks with a live key for some row of step n's stage: ranks 0 ..
  // last_of(n) (first_of grows with the rank; the set shrinks step by step)
  auto last_of = [&](int n) {
    int last = 0;
    while (last + 1 < nk && first_of(last + 1) <= nq - 1 - n) ++last;
    return last;
  };
  const int stat = (b * heads + h) * s_q;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the loads' expected bytes, 32 lanes
      mbar_init(&empty[s], kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&part_full[i], nk);  // rank 0's: one arrival a block
      mbar_init(&part_free[i], 1);   // from rank 0's reducers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block's barriers are set before a remote arrival

  if (wg == 0) {
    fused_producer_regs();
    if (threadIdx.x < 32) {  // warp 0 loads; lane 0 issues the tensor loads
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kTileKV);
        tma_tile<HD, kBlockRows>(sk, &tk, kv_full, k_axis, j0, h, b);
        tma_tile<HD, kBlockRows>(sv, &tv, kv_full, k_axis, j0, h, b);
      }
      for (int n = 0; n < live; ++n) {
        const int it = nq - 1 - n;
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::kTileQ);
          tma_tile<HD, kQRows>(sq + s * L::kTileQ, &tq, &full[s], q_axis,
                               it * kQRows, h, b);
          tma_tile<HD, kQRows>(sdo + s * L::kTileQ, &tdo, &full[s], q_axis,
                               it * kQRows, h, b);
        }
        for (int r = lane; r < kQRows; r += 32) {
          const int row = it * kQRows + r;
          slse[s * kQRows + r] = row < s_q ? lse[stat + row] : 0.f;
          sdl[s * kQRows + r] = row < s_q ? delta[stat + row] : 0.f;
        }
        mbar_arrive(&full[s]);  // releases this lane's rows
      }
    } else if (rank == 0) {  // warps 1-3 of rank 0: every dq row
      // (rank 0 is live at every step; the others leave as soon as their
      // partials are read, which frees their SMs)
      const int rt = threadIdx.x - 32;
      constexpr int kReducers = 96;
      constexpr int kVec = HD / 4;  // float4s a partial row
      constexpr int kUnroll = 2;    // float4 columns a thread reads at once
      const long long qrow0 = b * st.qb + h * st.qh;
      for (int n = 0; n < nq; ++n) {
        const int it = nq - 1 - n;
        const int last = last_of(n);
        // the blocks past `last` write nothing (or have left): counted here
        if (rt == 0 && last + 1 < nk)
          mbar_arrive_n(&part_full[n & 1], nk - 1 - last);
        mbar_wait_cluster(&part_full[n & 1], (n >> 1) & 1);
        const uint32_t slot = smem_u32(part) + (n & 1) * L::kPart;
        for (int i0 = rt; i0 < kQRows * kVec; i0 += kUnroll * kReducers) {
          // every partial of kUnroll columns in flight at once (a remote
          // read waits about as long as a global one), then summed in
          // rank order
          float4 x[kUnroll][kMaxCluster];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int idx = i0 + u * kReducers;
            const uint32_t a =
                slot + ((idx / kVec) * L::kPartLd + (idx % kVec) * 4) * 4;
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r)
              if (idx < kQRows * kVec && r <= last)
                x[u][r] = ld_cluster(map_rank(a, r));
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int idx = i0 + u * kReducers;
            const int qr = it * kQRows + idx / kVec;
            if (idx >= kQRows * kVec || qr >= s_q) continue;
            float4 sum = x[u][0];
#pragma unroll
            for (int r = 1; r < kMaxCluster; ++r)
              if (r <= last) {
                sum.x += x[u][r].x;
                sum.y += x[u][r].y;
                sum.z += x[u][r].z;
                sum.w += x[u][r].w;
              }
            __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
            __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
            uint2 pk;
            pk.x = *reinterpret_cast<uint32_t*>(&lo);
            pk.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(dq + qrow0 + qr * st.qr +
                                      (idx % kVec) * 4) = pk;
          }
        }
        named_sync(2, kReducers);  // every read of the stage's partials
        if (rt == 0)
          for (int r = 0; r <= last; ++r)
            mbar_arrive_remote(map_rank(smem_u32(&part_free[n & 1]), r));
      }
    }
  } else {  // consumers: 64 keys each
    fused_consumer_regs();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int g = lane >> 2;
    const int kw0 = j0 + 64 * w;
    const int k_lo = kw0 + warp * 16 + g;  // this thread's two keys
    const int k_hi = k_lo + 8;
    const int kl = 64 * w + warp * 16 + g;  // k_lo within the block's keys
    const float sl2 = scale * kLog2e;
    // dQ of a stage, 64 columns a warpgroup: at head_dim 128 each takes
    // half, at 64 the first takes all (two m64n32 halves were no faster)
    const bool dq_cols = w < HD / 64;
    // K's columns 64 w .. 64 w + 63 (one box) as the MN-major B operand
    const uint8_t* kcols = sk + w * kBlockRows * 128;
    // where this thread's round(dS) goes in (q, key) order: q rows 2t + e
    // (+ 8j, 1024 bytes on) of keys kl and kl + 8; four bases, so that no
    // address per element stays live across the stages
    uint32_t ds_at[2][2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ds_at[hi][e] = swizzled(2 * t + e, kl + 8 * hi, kQRows);
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      acc_k[i] = 0.f;
      acc_v[i] = 0.f;
    }

    mbar_wait(kv_full, 0);
    for (int n = 0; n < live; ++n) {
      const int it = nq - 1 - n;
      const int slot = n & 1;
      const int s = n % kStages;
      const uint8_t* qt = sq + s * L::kTileQ;
      const uint8_t* dot = sdo + s * L::kTileQ;
      const float* tl = slse + s * kQRows;
      const float* td = sdl + s * kQRows;
      mbar_wait(&full[s], (n / kStages) & 1);
      // S^T, dP^T: 64 keys x 64 query rows. Zeroed (the first product
      // overwrites them): an accumulator the asm reads before any write
      // would carry the last stage's registers around the loop
      float sct[32] = {}, dpt[32] = {};
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sct, desc_k<kBlockRows>(sk, 64 * w, kk),
                     desc_k<kQRows>(qt, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k<kBlockRows>(sv, 64 * w, kk),
                     desc_k<kQRows>(dot, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      pin(sct);
      pin(dpt);

      const int i0 = it * kQRows;
      const bool masked = i0 + kQRows > s_q || kw0 + 64 > s_k ||
                          (causal && i0 + off < kw0 + 63);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = 8 * (i >> 2) + 2 * t + (i & 1);  // query row in tile
        const bool hi = (i & 3) >= 2;
        const int key = hi ? k_hi : k_lo;
        float p = exp2f(sct[i] * sl2 - tl[r] * kLog2e);
        // padded q rows and keys are masked out of p (mask_q_rows)
        if (masked && !(i0 + r < s_q && key < s_k &&
                        (!causal || i0 + r + off >= key)))
          p = 0.f;
        sct[i] = p;
        dpt[i] = p * (dpt[i] - td[r]) * scale;  // dS^T
        // round(dS) in (q, key) order: the A operand of dQ
        *reinterpret_cast<bf16*>(sds + ds_at[hi][i & 1] + 1024 * (i >> 2)) =
            __float2bfloat16_rn(dpt[i]);
      }
      uint32_t pa[kQRows / 16][4], da[kQRows / 16][4];
      to_a<kQRows / 16>(pa, sct);
      to_a<kQRows / 16>(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs<HD>(acc_v, pa[kk], desc_mn<kQRows>(dot, kk));  // dV
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_rs<HD>(acc_k, da[kk], desc_mn<kQRows>(qt, kk));  // dK
      wgmma_commit();
      wgmma_wait();
      pin(acc_v);
      pin(acc_k);
      pin(pa);
      pin(da);
      mbar_arrive(&empty[s]);

      fence_async_smem();
      named_sync(1, kConsumers);  // round(dS) of the stage is whole
      float dqp[32] = {};  // this block's dQ of the stage, 64 columns
      if (dq_cols) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockRows / 16; ++kk)
          wgmma_ss_t_n64(dqp, desc_k<kQRows>(sds, 0, kk),
                         desc_mn<kBlockRows>(kcols, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        pin(dqp);
      }
      // the slot's partial of step n - 2 has been read
      if (n >= 2) mbar_wait_cluster(&part_free[slot], ((n - 2) >> 1) & 1);
      if (dq_cols) {
        float* pt = part + slot * (L::kPart / 4);
        const int row = warp * 16 + g;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = 64 * w + n8 * 8 + 2 * t;
          *reinterpret_cast<float2*>(pt + row * L::kPartLd + col) =
              make_float2(dqp[4 * n8], dqp[4 * n8 + 1]);
          *reinterpret_cast<float2*>(pt + (row + 8) * L::kPartLd + col) =
              make_float2(dqp[4 * n8 + 2], dqp[4 * n8 + 3]);
        }
      }
      // this block's partial of the step is whole; the arrival releases
      // it (the barrier orders every consumer's writes before it)
      named_sync(1, kConsumers);
      if (tid == 0 && w == 0)
        mbar_arrive_remote(map_rank(smem_u32(&part_full[slot]), 0));
    }
    // this block's last partials are read before it leaves
    for (int n = max(0, live - 2); n < live; ++n)
      mbar_wait_cluster(&part_free[n & 1], (n >> 1) & 1);

    const long long krow0 = b * st.kb + h * st.kh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (k_lo < s_k) {
        const long long o = krow0 + k_lo * st.kr + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[4 * n], acc_k[4 * n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[4 * n], acc_v[4 * n + 1]);
      }
      if (k_hi < s_k) {
        const long long o = krow0 + k_hi * st.kr + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[4 * n + 2], acc_k[4 * n + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[4 * n + 2], acc_v[4 * n + 3]);
      }
    }
  }
}

// ============================================================ host

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kGeo = 11;  // dims[4], byte strides[3], box[4] an operand
constexpr int kBadMap = -2;

// A bf16 operand's 4-D map from the wrapper's geometry (`tma_geometry`),
// 128-byte swizzle, zeros out of bounds. Checks the box against the tile
// the kernel expects (its expected bytes depend on it) and returns the
// map's row axis in *axis.
int encode_tile(CUtensorMap* map, const void* ptr, const long long* geo,
                int head_dim, int rows, int* axis) {
  const long long* dim = geo;
  const long long* stride = geo + 4;
  const long long* box = geo + 7;
  const bool row1 = box[1] == rows && box[2] == 1;
  const bool row2 = box[1] == 1 && box[2] == rows;
  if (dim[0] != head_dim || box[0] != kBox || box[3] != 1 || !(row1 || row2))
    return -1;
  *axis = row1 ? 1 : 2;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kBadMap;
  cuuint64_t d[4], s[3];
  cuuint32_t bx[4], es[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dim[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) s[i] = static_cast<cuuint64_t>(stride[i]);
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), d, s, bx, es,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

template <typename K>
cudaError_t allow_smem(K* kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The shared-memory opt-in runs once per kernel (a static per expansion):
// a later launch, inside a CUDA-graph capture say, makes no driver call.
#define FF_LAUNCH(KERN, BYTES, GRID, ...)                    \
  do {                                                       \
    static const cudaError_t smem = allow_smem(KERN, BYTES); \
    if (smem != cudaSuccess) return (int)smem;               \
    KERN<<<GRID, kThreads, BYTES, stream>>>(__VA_ARGS__);    \
  } while (0)

bool shape_ok(int batch, int heads, int s_q, int s_k, int head_dim,
              int causal) {
  return batch >= 1 && heads >= 1 && s_q >= 1 && s_k >= 1 &&
         (head_dim == 64 || head_dim == 128) && batch <= 65535 &&
         heads <= 65535 && !(causal && s_q > s_k) &&
         (long long)batch * heads * (s_q > s_k ? s_q : s_k) < (1ll << 31);
}

template <int HD>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, bf16* out, float* lse, int batch,
               int heads, int s_q, int s_k, float scale, int causal,
               int q_axis, int k_axis, const Strides& st,
               cudaStream_t stream) {
  const dim3 grid((s_q + kBlockRows - 1) / kBlockRows, heads, batch);
  FF_LAUNCH(flash_fwd_sm90<HD>, FwdSmem<HD>::bytes, grid, mq, mk, mv, out,
            lse, heads, s_q, s_k, scale, causal, q_axis, k_axis, st);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const CUtensorMap* m, const float* lse, const float* delta,
               bf16* dk, bf16* dv, int batch, int heads, int s_q, int s_k,
               float scale, int causal, int q_axis, int k_axis,
               const Strides& st, cudaStream_t stream) {
  const dim3 grid((s_k + kBlockRows - 1) / kBlockRows, heads, batch);
  FF_LAUNCH(flash_bwd_dkv_sm90<HD>, DkvSmem<HD>::bytes, grid, m[0], m[1],
            m[2], m[3], lse, delta, dk, dv, heads, s_q, s_k, scale, causal,
            q_axis, k_axis, st);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const CUtensorMap* m, const float* lse, const float* delta,
              bf16* dq, int batch, int heads, int s_q, int s_k, float scale,
              int causal, int q_axis, int k_axis, const Strides& st,
              cudaStream_t stream) {
  const dim3 grid((s_q + kBlockRows - 1) / kBlockRows, heads, batch);
  FF_LAUNCH(flash_bwd_dq_sm90<HD>, DqSmem<HD>::bytes, grid, m[0], m[1], m[2],
            m[3], lse, delta, dq, heads, s_q, s_k, scale, causal, q_axis,
            k_axis, st);
  return (int)cudaGetLastError();
}

#undef FF_LAUNCH

// K8: a cluster of ceil(s_k / 128) blocks along x for each (b, h)
template <int HD>
int launch_fused(const CUtensorMap* m, const float* lse, const float* delta,
                 bf16* dq, bf16* dk, bf16* dv, int batch, int heads, int s_q,
                 int s_k, float scale, int causal, int q_axis, int k_axis,
                 const Strides& st, cudaStream_t stream) {
  static const cudaError_t smem =
      allow_smem(flash_bwd_fused_sm90<HD>, FusedSmem<HD>::bytes);
  if (smem != cudaSuccess) return (int)smem;
  const unsigned nk = (s_k + kBlockRows - 1) / kBlockRows;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nk, heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = FusedSmem<HD>::bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, flash_bwd_fused_sm90<HD>, m[0], m[1], m[2], m[3], lse, delta, dq,
      dk, dv, heads, s_q, s_k, scale, causal, q_axis, k_axis, st);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound by ctypes. Pointers are device pointers; `geo`
// is a host array of the operands' TMA geometry, kGeo long longs each
// (dims, byte strides, box; `tma_geometry` in the wrapper): q, k, v for
// the forward, q, k, v, dO for the backward kernels. q, out, dO and dq
// share the element strides (q_sb, q_sh, q_sr) of batch, head and row; k,
// v, dk and dv share (k_sb, k_sh, k_sr). lse and delta are contiguous (b,
// h, s_q) f32. Each returns a cudaError_t code (0 = the launch was
// accepted), -1 for a shape it does not take (K8: also s_k > 512), or -2
// when a tensor map cannot be made.
#define FF_SM90_ARGS                                                      \
  const long long *geo, int batch, int heads, int s_q, int s_k,          \
      int head_dim, long long q_sb, long long q_sh, long long q_sr,      \
      long long k_sb, long long k_sh, long long k_sr, float scale,       \
      int causal, void *stream

extern "C" int ff_flash_attention_fwd_sm90(const void* q, const void* k,
                                           const void* v, void* out,
                                           float* lse, FF_SM90_ARGS) {
  if (!shape_ok(batch, heads, s_q, s_k, head_dim, causal)) return -1;
  CUtensorMap m[3];
  int axis[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_tile(&m[i], ptrs[i], geo + kGeo * i, head_dim,
                               i == 0 ? kBlockRows : kKvRows, &axis[i]);
    if (rc != 0) return rc;
  }
  if (axis[1] != axis[2]) return -1;
  const Strides st{q_sb, q_sh, q_sr, k_sb, k_sh, k_sr};
  cudaStream_t s = (cudaStream_t)stream;
  bf16* o = static_cast<bf16*>(out);
  return head_dim == 64
             ? launch_fwd<64>(m[0], m[1], m[2], o, lse, batch, heads, s_q,
                              s_k, scale, causal, axis[0], axis[1], st, s)
             : launch_fwd<128>(m[0], m[1], m[2], o, lse, batch, heads, s_q,
                               s_k, scale, causal, axis[0], axis[1], st, s);
}

// the four maps of the backward kernels (q, k, v, dO) with the box rows
// of each; q and dO share a row axis, k and v another
static int encode_bwd(CUtensorMap* m, int* axis, const void* q, const void* k,
               const void* v, const void* dout, const long long* geo,
               int head_dim, int q_rows, int k_rows) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int rows = (i == 0 || i == 3) ? q_rows : k_rows;
    const int rc = encode_tile(&m[i], ptrs[i], geo + kGeo * i, head_dim,
                               rows, &axis[i]);
    if (rc != 0) return rc;
  }
  return axis[0] != axis[3] || axis[1] != axis[2] ? -1 : 0;
}

extern "C" int ff_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, FF_SM90_ARGS) {
  if (!shape_ok(batch, heads, s_q, s_k, head_dim, causal)) return -1;
  CUtensorMap m[4];
  int axis[4];
  const int rc = encode_bwd(m, axis, q, k, v, dout, geo, head_dim,
                            kBlockRows, kDqKvRows);
  if (rc != 0) return rc;
  const Strides st{q_sb, q_sh, q_sr, k_sb, k_sh, k_sr};
  cudaStream_t s = (cudaStream_t)stream;
  bf16* o = static_cast<bf16*>(dq);
  return head_dim == 64
             ? launch_dq<64>(m, lse, delta, o, batch, heads, s_q, s_k, scale,
                             causal, axis[0], axis[1], st, s)
             : launch_dq<128>(m, lse, delta, o, batch, heads, s_q, s_k,
                              scale, causal, axis[0], axis[1], st, s);
}

extern "C" int ff_flash_attention_bwd_fused_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    FF_SM90_ARGS) {
  if (!shape_ok(batch, heads, s_q, s_k, head_dim, causal) ||
      s_k > kMaxCluster * kBlockRows)
    return -1;
  CUtensorMap m[4];
  int axis[4];
  const int rc = encode_bwd(m, axis, q, k, v, dout, geo, head_dim, kQRows,
                            kBlockRows);
  if (rc != 0) return rc;
  const Strides st{q_sb, q_sh, q_sr, k_sb, k_sh, k_sr};
  cudaStream_t s = (cudaStream_t)stream;
  bf16* a = static_cast<bf16*>(dq);
  bf16* b = static_cast<bf16*>(dk);
  bf16* c = static_cast<bf16*>(dv);
  return head_dim == 64
             ? launch_fused<64>(m, lse, delta, a, b, c, batch, heads, s_q,
                                s_k, scale, causal, axis[0], axis[1], st, s)
             : launch_fused<128>(m, lse, delta, a, b, c, batch, heads, s_q,
                                 s_k, scale, causal, axis[0], axis[1], st, s);
}

extern "C" int ff_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    FF_SM90_ARGS) {
  if (!shape_ok(batch, heads, s_q, s_k, head_dim, causal)) return -1;
  CUtensorMap m[4];
  int axis[4];
  const int rc = encode_bwd(m, axis, q, k, v, dout, geo, head_dim, kQRows,
                            kBlockRows);
  if (rc != 0) return rc;
  const Strides st{q_sb, q_sh, q_sr, k_sb, k_sh, k_sr};
  cudaStream_t s = (cudaStream_t)stream;
  bf16* a = static_cast<bf16*>(dk);
  bf16* b = static_cast<bf16*>(dv);
  return head_dim == 64
             ? launch_dkv<64>(m, lse, delta, a, b, batch, heads, s_q, s_k,
                              scale, causal, axis[0], axis[1], st, s)
             : launch_dkv<128>(m, lse, delta, a, b, batch, heads, s_q, s_k,
                               scale, causal, axis[0], axis[1], st, s);
}
