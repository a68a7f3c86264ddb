// Flash attention for training: the forward (K5), the FA2 backward split
// into dq (K6) and dk/dv (K7), and the fused single-tile backward (K8), on
// either layout through element strides.
//
// Replaces the TPU kernels (flexflow_tpu/kernels/flash_attention.py)
//   _flash_kernel_grouped (705), pallas_call at 946, via
//     _flash_fwd_packed_grouped (907)                              -> K5
//   _flash_kernel (117), pallas_call at 253 via _flash_fwd (222) and
//     at 1002 via _flash_fwd_packed (965)                          -> K5
//   _bwd_dq_kernel_grouped (808), pallas_call at 1045              -> K6
//   _bwd_dq_kernel (351), pallas_call at 546 via _flash_bwd (505)
//     and at 1145 via _flash_bwd_packed (1087)                     -> K6
//   _bwd_dkv_kernel_grouped (854), pallas_call at 1064             -> K7
//   _bwd_dkv_kernel (392), pallas_call at 563 via _flash_bwd (505)
//     and at 1164 via _flash_bwd_packed (1087)                     -> K7
//   _bwd_single_tile_kernel (442), pallas_call at 483 via
//     _flash_bwd_single_tile (478) and at 1120 via
//     _flash_bwd_packed (1087)                                     -> K8
// reached from flash_attention_packed (1212), flash_attention (1608) and
// flash_attention_with_lse (657) through their custom VJPs.
//
// Layout: every kernel addresses head h of batch b through element strides
// (batch, head, row), one set for q, out, dO and dq and one for k, v, dk
// and dv; the head dim is unit-stride. The packed projections' layout
// (b, s, h*d) has strides (s*e, d, e) with e = h*d, the transposed
// (b, h, s, d) layout (h*s*d, s*d, d): one kernel per function serves
// both, with no relayout. The TPU path groups narrow heads into 128-lane
// stripes; on a GPU a block addresses one head directly, so one kernel
// serves every head width up to 128 (templated on the head dim padded to
// 32, 64 or 128 with zero columns, which change no product). lse and delta
// are (b, h, s) f32 in both layouts (the TPU keeps 128 lanes of copies).
//
// What K5 computes, per (b, h) and query row i over keys j < s_k:
//   logit_ij = (q_i . k_j) * scale        (f32 accumulation, then scale)
//   masked logits (causal: i + s_k - s_q < j) are -1e30, the TPU NEG_INF
//   online softmax over key tiles in f32: m, l = sum p, and
//   acc += round(p) . v with p rounded to v's dtype before the product
//   out = acc / l, cast once;  lse = m + log(l)
// Tiles entirely above the causal diagonal are skipped; rows past s_k are
// zero-filled in shared memory, so padded V rows are zero as in the TPU
// kernel. JAX runs seq <= 512 in one key pass (one-pass softmax); the
// tiled online softmax here differs from it only where p is rounded to
// bf16 (against the running instead of the final row max). Causal
// attention with s_q > s_k (rows with no live key) is not taken: the
// entries route that shape to sdpa_xla, as the JAX package does, and the
// kernel functions refuse it.
//
// K6, K7 and K8 recompute p = exp(logit - lse) (0 where masked) and
//   ds = p * (dp - delta) * scale,  dp = dO . v,  delta = rowsum(dO * O)
// (_bwd_tile_math, 277-333). K6, one block per (b, h, q tile), walks the
// live kv tiles: dq += round(ds) . k. K7, one block per (b, h, kv tile),
// walks the q tiles from the diagonal down: dv += round(p)^T . dO and
// dk += round(ds)^T . q, with padded q rows masked out of p. K8 is the
// fused backward the JAX package runs when the sequence fits one tile
// (s_q, s_k <= 512): p and ds are formed once per (q tile, kv tile) pair
// and feed all three products. One block per (b, h) walks the kv tiles;
// for each it walks the live q tiles as K7 does (dK, dV in registers) and
// adds round(ds) . k into an f32 (b, h, s_q, d) scratch that the wrapper
// allocates, then casts dq once at the end. Each output element, scratch
// included, has one writer thread, so there are no atomics and results do
// not change from run to run.
//
// Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16). lm-base (b 8, 16 heads
// of 64, s 512, bf16, causal): bytes. K5 reads q, k, v and writes out
// (34 MB, 10 us), K6 ~42 MB, K7 ~50 MB (13-15 us), against 2-6 us of
// tensor-core work; K8 reads q, k, v, dO, lse, delta and writes dq, dk,
// dv: 59 MB, 17.7 us, against 10.9 us for its five products. lm-xxl-fsdp
// (b 4, 32 heads of 128, s 2048): tensor-core work, 68.8 GFLOP a product:
// K5 139 us (bytes 80), K6 208 us (101), K7 278 us (121).
//
// Design, bf16 (the training path): FlashAttention-2's. Four warps per
// block, each owning 16 rows of the block's 64-row tile (query rows for K5
// and K6, key rows for K7 and K8). The tile of the streamed operand (K and
// V for K5 and K6; Q and dO for K7 and K8) is double-buffered in shared
// memory with cp.async, so the next tile's loads overlap this tile's math.
// Products run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// operands read by ldmatrix; S, P, dP, dS and the accumulators never leave
// registers: the f32 accumulator fragment of S is the bf16 A fragment of P
// after rounding, so P.V needs no shared-memory round trip, and K7/K8 work
// on the transposed tiles (K.Q^T, V.dO^T) so that dV and dK accumulate the
// same way. K8 also writes round(dS) of the pair to shared memory in
// (q, key) order, so that each warp forms dQ for 16 query rows over all 64
// keys of the tile. Row statistics reduce across the four lanes of a row
// (quad shuffles).
//
// Design, f32 (parity checks and f32 training): full f32 on SIMT FMAs (the
// port turns TF32 off and the f32 checks rely on it), 32-row tiles with
// every intermediate in shared memory, a sync between passes. A plain
// correct kernel.
//
// In bf16 at head_dim 64 and 128 with strides TMA takes (every path of
// the zoo), K5 and K7 run the wgmma/TMA kernels of
// csrc/flash_attention_sm90.cu instead; the mma.sync K5 and K7 here serve
// the other bf16 shapes, and their walk (mma_dkv_walk) is also K8's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Element strides of the two tensor groups: q, out, dO, dq (q*) and k, v,
// dk, dv (k*), by batch, head and row.
struct Strides {
  long long qb, qh, qr;
  long long kb, kh, kr;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// over the four lanes that hold one row of an mma fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the kv extent a q tile [i0, i0 + br) sees: keys past the causal diagonal
// of its last row are dead (s_k - s_q >= 0 is the wrapper's contract)
__device__ __forceinline__ int kv_end(int i0, int br, int s_q, int s_k,
                                      int causal) {
  return causal ? min(s_k, i0 + br + (s_k - s_q)) : s_k;
}

__device__ __forceinline__ bool live(int i, int j, int s_q, int s_k,
                                     int causal) {
  return i < s_q && j < s_k && (!causal || i + (s_k - s_q) >= j);
}

// the first query row that sees key j0 under the causal mask
__device__ __forceinline__ int first_row(int j0, int s_q, int s_k,
                                         int causal) {
  return causal ? max(0, j0 - (s_k - s_q)) : 0;
}

// Rows [0, R) of one head into shared memory dst (ld elements a row):
// src points at the head's first column of the tile's first row, rows are
// row_stride elements apart. Rows >= rows_valid and columns >= d are zero.
// vec: d == HD and every row start 16-byte aligned (16-byte loads).
template <typename T, int R, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride,
                                          int rows_valid, int d, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kVecs = HD / kPer;
    for (int idx = threadIdx.x; idx < R * kVecs; idx += kThreads) {
      const int r = idx / kVecs;
      const int c = (idx % kVecs) * kPer;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < R * HD; idx += kThreads) {
      const int r = idx / HD;
      const int c = idx % HD;
      T val = T(0.f);
      if (r < rows_valid && c < d) val = src[r * row_stride + c];
      dst[r * ld + c] = val;
    }
  }
}

// ===================================================== f32: SIMT kernels

constexpr int kRowsF32 = 32;  // query and key rows per f32 tile

// C[M x N] (shared, row-major, ldc) = (accumulate ? C : 0) + A . B in f32
// FMAs. A_ROW: A(i, k) at A[i*lda + k], else at A[k*lda + i]. B_ROW:
// B(k, j) at B[k*ldb + j], else at B[j*ldb + k]. Every thread of the block
// calls it; the caller syncs.
template <int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void block_fma(const float* A, int lda,
                                          const float* B, int ldb, float* C,
                                          int ldc, bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N;
    const int j = idx % N;
    float acc = accumulate ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_ROW ? A[i * lda + k] : A[k * lda + i];
      const float b = B_ROW ? B[k * ldb + j] : B[j * ldb + k];
      acc = fmaf(a, b, acc);
    }
    C[i * ldc + j] = acc;
  }
}

// Shared-memory layout of the f32 kernels; rows padded so they do not all
// start in the same bank.
template <int HD>
struct F32Lay {
  static constexpr int BR = kRowsF32;
  static constexpr int LDT = HD + 8;  // q, k, v, dO tiles
  static constexpr int LDS = BR + 4;  // score tiles (S, P, dP, dS)
  static constexpr int LDO = HD + 4;  // accumulators
  static constexpr size_t kTileT = sizeof(float) * BR * LDT;
  static constexpr size_t kTileS = sizeof(float) * BR * LDS;
  static constexpr size_t kTileO = sizeof(float) * BR * LDO;
  static constexpr size_t kRowsF = sizeof(float) * BR;
};

// K5: q, k, v tiles, S (P in place), O accumulator, per-row m, l, alpha
template <int HD>
struct F32Fwd : F32Lay<HD> {
  using L = F32Lay<HD>;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + L::kTileT);
  static constexpr size_t v = align128(k + L::kTileT);
  static constexpr size_t s = align128(v + L::kTileT);
  static constexpr size_t o = align128(s + L::kTileS);
  static constexpr size_t m = align128(o + L::kTileO);
  static constexpr size_t l = align128(m + L::kRowsF);
  static constexpr size_t alpha = align128(l + L::kRowsF);
  static constexpr size_t bytes = align128(alpha + L::kRowsF);
};

// K6, K7 and K8: q, dO, k, v tiles, S (P in place), dP (dS in place),
// three accumulators (K6 uses one, K7 two), per-row lse and delta
template <int HD>
struct F32Bwd : F32Lay<HD> {
  using L = F32Lay<HD>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = align128(q + L::kTileT);
  static constexpr size_t k = align128(dout + L::kTileT);
  static constexpr size_t v = align128(k + L::kTileT);
  static constexpr size_t s = align128(v + L::kTileT);
  static constexpr size_t dp = align128(s + L::kTileS);
  static constexpr size_t acc0 = align128(dp + L::kTileS);
  static constexpr size_t acc1 = align128(acc0 + L::kTileO);
  static constexpr size_t acc2 = align128(acc1 + L::kTileO);
  static constexpr size_t lse = align128(acc2 + L::kTileO);
  static constexpr size_t delta = align128(lse + L::kRowsF);
  static constexpr size_t bytes = align128(delta + L::kRowsF);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int heads, int s_q, int s_k, int d,
              float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  using S = F32Fwd<HD>;
  constexpr int BR = S::BR;
  const int nq = (s_q + BR - 1) / BR;
  const int i0 = (nq - 1 - blockIdx.x) * BR;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float* sq = reinterpret_cast<float*>(ff_smem + S::q);
  float* sk = reinterpret_cast<float*>(ff_smem + S::k);
  float* sv = reinterpret_cast<float*>(ff_smem + S::v);
  float* ss = reinterpret_cast<float*>(ff_smem + S::s);
  float* so = reinterpret_cast<float*>(ff_smem + S::o);
  float* sm = reinterpret_cast<float*>(ff_smem + S::m);
  float* sl = reinterpret_cast<float*>(ff_smem + S::l);
  float* salpha = reinterpret_cast<float*>(ff_smem + S::alpha);

  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + i0 * st.qr, st.qr,
                           min(BR, s_q - i0), d, vec);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads)
    so[(idx / HD) * S::LDO + idx % HD] = 0.f;
  for (int r = threadIdx.x; r < BR; r += kThreads) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }

  const int nkv = (kv_end(i0, BR, s_q, s_k, causal) + BR - 1) / BR;
  for (int jt = 0; jt < nkv; ++jt) {
    const int j0 = jt * BR;
    __syncthreads();  // the last tile's readers of k, v and p are done
    load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + j0 * st.kr, st.kr,
                             min(BR, s_k - j0), d, vec);
    load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + j0 * st.kr, st.kr,
                             min(BR, s_k - j0), d, vec);
    __syncthreads();
    block_fma<BR, BR, HD, true, false>(sq, S::LDT, sk, S::LDT, ss, S::LDS,
                                       false);  // S = Q K^T
    __syncthreads();
    // online softmax, one warp per row, one score per lane
    for (int r = warp; r < BR; r += kWarps) {
      float x = ss[r * S::LDS + lane] * scale;
      // rows past s_q (never written) are all masked and stay finite
      if (!live(i0 + r, j0 + lane, s_q, s_k, causal)) x = kNegInf;
      const float m_old = sm[r];
      // finite: key 0 of the first tile is live for every row
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);
      ss[r * S::LDS + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // m_old = -inf -> 0
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        salpha[r] = alpha;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
      const int r = idx / HD;
      so[r * S::LDO + idx % HD] *= salpha[r];
    }
    __syncthreads();
    block_fma<BR, HD, BR, true, true>(ss, S::LDS, sv, S::LDT, so, S::LDO,
                                      true);  // O += P V
  }
  __syncthreads();
  const int rows = min(BR, s_q - i0);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    if (r < rows && c < d)
      out[qrow0 + (i0 + r) * st.qr + c] = so[r * S::LDO + c] / sl[r];
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    lse[((long long)b * heads + h) * s_q + i0 + r] = sm[r] + logf(sl[r]);
}

// rows [i0, i0 + br) of lse and delta into shared memory, 0 past s_q
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int i0, int br, int s_q) {
  for (int r = threadIdx.x; r < br; r += kThreads)
    dst[r] = i0 + r < s_q ? src[i0 + r] : 0.f;
}

// p and ds of one (q tile, kv tile) pair, in place of the S and dP tiles:
// p = exp(S*scale - lse) where live, else 0; ds = p * (dp - delta) * scale
template <int HD>
__device__ __forceinline__ void f32_bwd_tile(float* ss, float* sdp,
                                             const float* slse,
                                             const float* sdelta, int i0,
                                             int j0, int s_q, int s_k,
                                             float scale, int causal) {
  using L = F32Lay<HD>;
  constexpr int BR = L::BR;
  for (int idx = threadIdx.x; idx < BR * BR; idx += kThreads) {
    const int r = idx / BR;
    const int c = idx % BR;
    float p = 0.f;
    if (live(i0 + r, j0 + c, s_q, s_k, causal))
      p = expf(ss[r * L::LDS + c] * scale - slse[r]);
    ss[r * L::LDS + c] = p;
    sdp[r * L::LDS + c] = p * (sdp[r * L::LDS + c] - sdelta[r]) * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int heads, int s_q, int s_k, int d, float scale, int causal,
                 int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  const int nq = (s_q + BR - 1) / BR;
  const int i0 = (nq - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  float* sq = reinterpret_cast<float*>(ff_smem + S::q);
  float* sdo = reinterpret_cast<float*>(ff_smem + S::dout);
  float* sk = reinterpret_cast<float*>(ff_smem + S::k);
  float* sv = reinterpret_cast<float*>(ff_smem + S::v);
  float* ss = reinterpret_cast<float*>(ff_smem + S::s);
  float* sdp = reinterpret_cast<float*>(ff_smem + S::dp);
  float* sdq = reinterpret_cast<float*>(ff_smem + S::acc0);
  float* slse = reinterpret_cast<float*>(ff_smem + S::lse);
  float* sdelta = reinterpret_cast<float*>(ff_smem + S::delta);

  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long row_stat = ((long long)b * heads + h) * s_q;
  const int rows = min(BR, s_q - i0);
  load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + i0 * st.qr, st.qr, rows,
                           d, vec);
  load_tile<float, BR, HD>(sdo, S::LDT, dout + qrow0 + i0 * st.qr, st.qr,
                           rows, d, vec);
  load_rows(slse, lse + row_stat, i0, BR, s_q);
  load_rows(sdelta, delta + row_stat, i0, BR, s_q);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads)
    sdq[(idx / HD) * S::LDO + idx % HD] = 0.f;

  const int nkv = (kv_end(i0, BR, s_q, s_k, causal) + BR - 1) / BR;
  for (int jt = 0; jt < nkv; ++jt) {
    const int j0 = jt * BR;
    __syncthreads();
    load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + j0 * st.kr, st.kr,
                             min(BR, s_k - j0), d, vec);
    load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + j0 * st.kr, st.kr,
                             min(BR, s_k - j0), d, vec);
    __syncthreads();
    block_fma<BR, BR, HD, true, false>(sq, S::LDT, sk, S::LDT, ss, S::LDS,
                                       false);  // S = Q K^T
    block_fma<BR, BR, HD, true, false>(sdo, S::LDT, sv, S::LDT, sdp, S::LDS,
                                       false);  // dP = dO V^T
    __syncthreads();
    f32_bwd_tile<HD>(ss, sdp, slse, sdelta, i0, j0, s_q, s_k, scale, causal);
    __syncthreads();
    block_fma<BR, HD, BR, true, true>(sdp, S::LDS, sk, S::LDT, sdq, S::LDO,
                                      true);  // dQ += dS K
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    if (r < rows && c < d)
      dq[qrow0 + (i0 + r) * st.qr + c] = sdq[r * S::LDO + c];
  }
}

// The q-tile walk of one kv tile shared by K7 and K8 (f32): dK, dV += the
// pair's products into sdk, sdv; with FUSED, also dQ of each q tile, added
// into the f32 scratch acc ((s_q, d) rows of this head; the first kv tile
// stores). Each scratch element has one writer thread.
template <int HD, bool FUSED>
__device__ __forceinline__ void f32_dkv_walk(
    const float* q, const float* dout, const float* lse, const float* delta,
    float* acc, unsigned char* smem, long long qrow0, int j0, bool first_kv,
    int s_q, int s_k, int d, float scale, int causal, bool vec,
    const Strides& st) {
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  float* sq = reinterpret_cast<float*>(smem + S::q);
  float* sdo = reinterpret_cast<float*>(smem + S::dout);
  float* sk = reinterpret_cast<float*>(smem + S::k);
  float* sv = reinterpret_cast<float*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* sdp = reinterpret_cast<float*>(smem + S::dp);
  float* sdk = reinterpret_cast<float*>(smem + S::acc0);
  float* sdv = reinterpret_cast<float*>(smem + S::acc1);
  float* sdq = reinterpret_cast<float*>(smem + S::acc2);
  float* slse = reinterpret_cast<float*>(smem + S::lse);
  float* sdelta = reinterpret_cast<float*>(smem + S::delta);
  const int nq = (s_q + BR - 1) / BR;
  for (int it = first_row(j0, s_q, s_k, causal) / BR; it < nq; ++it) {
    const int i0 = it * BR;
    const int rows = min(BR, s_q - i0);
    __syncthreads();
    load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + i0 * st.qr, st.qr,
                             rows, d, vec);
    load_tile<float, BR, HD>(sdo, S::LDT, dout + qrow0 + i0 * st.qr, st.qr,
                             rows, d, vec);
    load_rows(slse, lse, i0, BR, s_q);
    load_rows(sdelta, delta, i0, BR, s_q);
    __syncthreads();
    block_fma<BR, BR, HD, true, false>(sq, S::LDT, sk, S::LDT, ss, S::LDS,
                                       false);  // S = Q K^T
    block_fma<BR, BR, HD, true, false>(sdo, S::LDT, sv, S::LDT, sdp, S::LDS,
                                       false);  // dP = dO V^T
    __syncthreads();
    f32_bwd_tile<HD>(ss, sdp, slse, sdelta, i0, j0, s_q, s_k, scale, causal);
    __syncthreads();
    block_fma<BR, HD, BR, false, true>(ss, S::LDS, sdo, S::LDT, sdv, S::LDO,
                                       true);  // dV += P^T dO
    block_fma<BR, HD, BR, false, true>(sdp, S::LDS, sq, S::LDT, sdk, S::LDO,
                                       true);  // dK += dS^T Q
    if (FUSED) {
      block_fma<BR, HD, BR, true, true>(sdp, S::LDS, sk, S::LDT, sdq,
                                        S::LDO, false);  // dS K
      __syncthreads();
      for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
        const int r = idx / HD;
        const int c = idx % HD;
        if (r < rows && c < d) {
          float* a = acc + (long long)(i0 + r) * d + c;
          *a = (first_kv ? 0.f : *a) + sdq[r * S::LDO + c];
        }
      }
    }
  }
}

// stage one kv tile's k and v rows and zero the dK, dV accumulators
template <int HD>
__device__ __forceinline__ void f32_kv_tile(const float* k, const float* v,
                                            unsigned char* smem,
                                            long long krow0, int j0,
                                            int krows, int d, bool vec,
                                            const Strides& st) {
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  float* sk = reinterpret_cast<float*>(smem + S::k);
  float* sv = reinterpret_cast<float*>(smem + S::v);
  float* sdk = reinterpret_cast<float*>(smem + S::acc0);
  float* sdv = reinterpret_cast<float*>(smem + S::acc1);
  load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + j0 * st.kr, st.kr, krows,
                           d, vec);
  load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + j0 * st.kr, st.kr, krows,
                           d, vec);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int o = (idx / HD) * S::LDO + idx % HD;
    sdk[o] = 0.f;
    sdv[o] = 0.f;
  }
}

// the kv tile's dK and dV rows from the accumulators (after a sync)
template <int HD>
__device__ __forceinline__ void f32_store_dkv(float* dk, float* dv,
                                              const unsigned char* smem,
                                              long long krow0, int j0,
                                              int krows, int d,
                                              const Strides& st) {
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  const float* sdk = reinterpret_cast<const float*>(smem + S::acc0);
  const float* sdv = reinterpret_cast<const float*>(smem + S::acc1);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    if (r < krows && c < d) {
      const long long o = krow0 + (j0 + r) * st.kr + c;
      dk[o] = sdk[r * S::LDO + c];
      dv[o] = sdv[r * S::LDO + c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int heads, int s_q, int s_k, int d,
                  float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int BR = kRowsF32;
  const int j0 = blockIdx.x * BR;  // the first kv tiles see the most q rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long row_stat = ((long long)b * heads + h) * s_q;
  const int krows = min(BR, s_k - j0);
  f32_kv_tile<HD>(k, v, ff_smem, krow0, j0, krows, d, vec, st);
  f32_dkv_walk<HD, false>(q, dout, lse + row_stat, delta + row_stat,
                          nullptr, ff_smem, qrow0, j0, false, s_q, s_k, d,
                          scale, causal, vec, st);
  __syncthreads();
  f32_store_dkv<HD>(dk, dv, ff_smem, krow0, j0, krows, d, st);
}

// K8, f32: one block per (b, h) walks every kv tile
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dq_acc, int heads, int s_q, int s_k,
                    int d, float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int BR = kRowsF32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long row_stat = ((long long)b * heads + h) * s_q;
  float* acc = dq_acc + row_stat * d;
  const int nk = (s_k + BR - 1) / BR;
  for (int jt = 0; jt < nk; ++jt) {
    const int j0 = jt * BR;
    const int krows = min(BR, s_k - j0);
    __syncthreads();  // the last kv tile's readers and writers are done
    f32_kv_tile<HD>(k, v, ff_smem, krow0, j0, krows, d, vec, st);
    // the first kv tile walks every q tile: it stores each scratch row
    f32_dkv_walk<HD, true>(q, dout, lse + row_stat, delta + row_stat, acc,
                           ff_smem, qrow0, j0, jt == 0, s_q, s_k, d, scale,
                           causal, vec, st);
    __syncthreads();
    f32_store_dkv<HD>(dk, dv, ff_smem, krow0, j0, krows, d, st);
  }
  __syncthreads();  // every scratch row of this head is summed
  for (int idx = threadIdx.x; idx < s_q * d; idx += kThreads)
    dq[qrow0 + (idx / d) * st.qr + idx % d] = acc[idx];
}

// ============================================ bf16: mma.sync fragments

constexpr int kRows = 64;          // rows per bf16 tile: 4 warps x 16
constexpr int kTileN = kRows / 8;  // 8-column mma n-tiles across a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even, as torch's cast), packed
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments of a warp, with g = lane / 4 and t = lane % 4 (PTX ISA,
// mma.m16n8k16): an A fragment (16 x 16) holds rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9; a B fragment (16 x 8) rows (k) 2t, 2t + 1
// and 2t + 8, 2t + 9 of column (n) g; an accumulator (16 x 8) rows g and
// g + 8, columns 2t, 2t + 1.

// A fragment of the 16 x 16 block at (r0, c0) of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4(a, s + (r0 + (lane & 7) + (m & 1) * 8) * ld + c0 + (m >> 1) * 8);
}

// B fragments of two n-tiles, columns n0..n0+15 and rows (k) k0..k0+15,
// of a tile stored n-major ([n][k], as K is for S = Q K^T): b[0..1] for
// n0, b[2..3] for n0 + 8
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4(b, s + (n0 + (lane & 7) + (m >> 1) * 8) * ld + k0 + (m & 1) * 8);
}

// the same from a tile stored k-major ([k][n], as V is for P V), through
// the transposing ldmatrix
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (m & 1) * 8) * ld + n0 + (m >> 1) * 8);
}

// acc = this warp's 16 rows (from r0) of sa times sb^T over HD: sa and sb
// are [kRows][HD + 8] tiles, sb n-major, so acc covers all kRows rows of sb
template <int HD>
__device__ __forceinline__ void scores(float (&acc)[kTileN][4],
                                       const bf16* sa, const bf16* sb,
                                       int r0) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < kTileN; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, sa, LD, r0, kk * 16);
#pragma unroll
    for (int np = 0; np < kTileN / 2; ++np) {
      uint32_t bb[4];
      frag_b_nk(bb, sb, LD, np * 16, kk * 16);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// out += round(p) . sb: p is a 16 x kRows accumulator (the accumulator
// fragment of two n-tiles, rounded, is the A fragment of one k-step), sb a
// [kRows][HD + 8] tile stored k-major
template <int HD>
__device__ __forceinline__ void accumulate_pb(float (&out)[HD / 8][4],
                                              const float (&p)[kTileN][4],
                                              const bf16* sb) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint32_t a[4] = {
        pack(p[2 * kk][0], p[2 * kk][1]), pack(p[2 * kk][2], p[2 * kk][3]),
        pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bb[4];
      frag_b_kn(bb, sb, LD, kk * 16, np * 16);
      mma(out[2 * np], a, bb[0], bb[1]);
      mma(out[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A kRows-row tile of one head into shared memory ([kRows][HD + 8]):
// with cp.async when vec (the caller commits), else by plain loads; rows
// past rows_valid and columns past d are zero
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long row_stride, int rows_valid,
                                      int d, bool vec) {
  constexpr int LD = HD + 8;
  if (vec) {
    constexpr int kVecs = HD / 8;
    for (int idx = threadIdx.x; idx < kRows * kVecs; idx += kThreads) {
      const int r = idx / kVecs;
      const int c = (idx % kVecs) * 8;
      const bool ok = r < rows_valid;
      // a zero-byte copy reads nothing, but takes a valid address
      cp_async16(dst + r * LD + c, src + (ok ? r * row_stride + c : 0), ok);
    }
  } else {
    load_tile<bf16, kRows, HD>(dst, LD, src, row_stride, rows_valid, d,
                               false);
  }
}

// wait for every staged tile but the newest group when one is pending
__device__ __forceinline__ void stage_wait(bool vec, bool pending) {
  if (vec) {
    if (pending) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
  }
}

template <int HD>
struct MmaSmem {
  static constexpr size_t kTile = sizeof(bf16) * kRows * (HD + 8);
  static constexpr size_t fwd = 5 * kTile;  // q, 2 x (k, v)
  static constexpr size_t dq = 6 * kTile;   // q, dO, 2 x (k, v)
  // k, v, 2 x (q, dO), 2 x (lse, delta) rows
  static constexpr size_t dkv = 6 * kTile + 4 * kRows * sizeof(float);
  // K7's, and round(dS) of one pair, [q][key]
  static constexpr size_t fused = dkv + sizeof(bf16) * kRows * (kRows + 8);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ lse, int heads, int s_q, int s_k, int d,
              float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int TILE = kRows * (HD + 8);
  bf16* sq = reinterpret_cast<bf16*>(ff_smem);
  bf16* sk = sq + TILE;      // two buffers
  bf16* sv = sk + 2 * TILE;  // two buffers
  const int nq = (s_q + kRows - 1) / kRows;
  const int i0 = (nq - 1 - blockIdx.x) * kRows;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const int r_lo = i0 + warp * 16 + (lane >> 2);  // this thread's two rows
  const int r_hi = r_lo + 8;

  stage<HD>(sq, q + qrow0 + i0 * st.qr, st.qr, s_q - i0, d, vec);
  stage<HD>(sk, k + krow0, st.kr, s_k, d, vec);
  stage<HD>(sv, v + krow0, st.kr, s_k, d, vec);
  if (vec) cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
  float l_lo = 0.f, l_hi = 0.f;

  const int nkv = (kv_end(i0, kRows, s_q, s_k, causal) + kRows - 1) / kRows;
  for (int jt = 0; jt < nkv; ++jt) {
    const int buf = jt & 1;
    const bool more = jt + 1 < nkv;
    if (more) {  // the next tile into the other buffer, read a tile ago
      const int jn = (jt + 1) * kRows;
      stage<HD>(sk + (buf ^ 1) * TILE, k + krow0 + jn * st.kr, st.kr,
                s_k - jn, d, vec);
      stage<HD>(sv + (buf ^ 1) * TILE, v + krow0 + jn * st.kr, st.kr,
                s_k - jn, d, vec);
      if (vec) cp_async_commit();
    }
    stage_wait(vec, more);
    __syncthreads();
    float s[kTileN][4];
    scores<HD>(s, sq, sk + buf * TILE, warp * 16);  // S = Q K^T
    const int j0 = jt * kRows;
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + j * 8 + 2 * t + c;
        // rows past s_q (never written) are all masked and stay finite
        float x = s[j][c] * scale;
        float y = s[j][2 + c] * scale;
        if (!live(r_lo, col, s_q, s_k, causal)) x = kNegInf;
        if (!live(r_hi, col, s_q, s_k, causal)) y = kNegInf;
        s[j][c] = x;
        s[j][2 + c] = y;
        mx_lo = fmaxf(mx_lo, x);
        mx_hi = fmaxf(mx_hi, y);
      }
    // finite: key 0 of the first tile is live for every row
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[j][c] = expf(s[j][c] - mn_lo);
        s[j][2 + c] = expf(s[j][2 + c] - mn_hi);
        sum_lo += s[j][c];
        sum_hi += s[j][2 + c];
      }
    const float a_lo = expf(m_lo - mn_lo);  // m = -inf (first tile) -> 0
    const float a_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * a_lo + quad_sum(sum_lo);
    l_hi = l_hi * a_hi + quad_sum(sum_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= a_lo;
      o[n][1] *= a_lo;
      o[n][2] *= a_hi;
      o[n][3] *= a_hi;
    }
    accumulate_pb<HD>(o, s, sv + buf * TILE);  // O += round(P) V
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n * 8 + 2 * t + c;
      if (col < d) {
        if (r_lo < s_q)
          out[qrow0 + r_lo * st.qr + col] = __float2bfloat16(o[n][c] / l_lo);
        if (r_hi < s_q)
          out[qrow0 + r_hi * st.qr + col] =
              __float2bfloat16(o[n][2 + c] / l_hi);
      }
    }
  if (t == 0) {
    const long long stat = ((long long)b * heads + h) * s_q;
    if (r_lo < s_q) lse[stat + r_lo] = m_lo + logf(l_lo);
    if (r_hi < s_q) lse[stat + r_hi] = m_hi + logf(l_hi);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int heads, int s_q, int s_k, int d, float scale, int causal,
                 int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int TILE = kRows * (HD + 8);
  bf16* sq = reinterpret_cast<bf16*>(ff_smem);
  bf16* sdo = sq + TILE;
  bf16* sk = sdo + TILE;     // two buffers
  bf16* sv = sk + 2 * TILE;  // two buffers
  const int nq = (s_q + kRows - 1) / kRows;
  const int i0 = (nq - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long stat = ((long long)b * heads + h) * s_q;
  const int r_lo = i0 + warp * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;

  stage<HD>(sq, q + qrow0 + i0 * st.qr, st.qr, s_q - i0, d, vec);
  stage<HD>(sdo, dout + qrow0 + i0 * st.qr, st.qr, s_q - i0, d, vec);
  stage<HD>(sk, k + krow0, st.kr, s_k, d, vec);
  stage<HD>(sv, v + krow0, st.kr, s_k, d, vec);
  if (vec) cp_async_commit();
  const float lse_lo = r_lo < s_q ? lse[stat + r_lo] : 0.f;
  const float lse_hi = r_hi < s_q ? lse[stat + r_hi] : 0.f;
  const float dl_lo = r_lo < s_q ? delta[stat + r_lo] : 0.f;
  const float dl_hi = r_hi < s_q ? delta[stat + r_hi] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  const int nkv = (kv_end(i0, kRows, s_q, s_k, causal) + kRows - 1) / kRows;
  for (int jt = 0; jt < nkv; ++jt) {
    const int buf = jt & 1;
    const bool more = jt + 1 < nkv;
    if (more) {
      const int jn = (jt + 1) * kRows;
      stage<HD>(sk + (buf ^ 1) * TILE, k + krow0 + jn * st.kr, st.kr,
                s_k - jn, d, vec);
      stage<HD>(sv + (buf ^ 1) * TILE, v + krow0 + jn * st.kr, st.kr,
                s_k - jn, d, vec);
      if (vec) cp_async_commit();
    }
    stage_wait(vec, more);
    __syncthreads();
    float s[kTileN][4], dp[kTileN][4];
    scores<HD>(s, sq, sk + buf * TILE, warp * 16);    // S = Q K^T
    scores<HD>(dp, sdo, sv + buf * TILE, warp * 16);  // dP = dO V^T
    const int j0 = jt * kRows;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + j * 8 + 2 * t + c;
        const float p_lo = live(r_lo, col, s_q, s_k, causal)
                               ? expf(s[j][c] * scale - lse_lo) : 0.f;
        const float p_hi = live(r_hi, col, s_q, s_k, causal)
                               ? expf(s[j][2 + c] * scale - lse_hi) : 0.f;
        s[j][c] = p_lo * (dp[j][c] - dl_lo) * scale;  // ds
        s[j][2 + c] = p_hi * (dp[j][2 + c] - dl_hi) * scale;
      }
    accumulate_pb<HD>(acc, s, sk + buf * TILE);  // dQ += round(dS) K
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n * 8 + 2 * t + c;
      if (col < d) {
        if (r_lo < s_q)
          dq[qrow0 + r_lo * st.qr + col] = __float2bfloat16(acc[n][c]);
        if (r_hi < s_q)
          dq[qrow0 + r_hi * st.qr + col] = __float2bfloat16(acc[n][2 + c]);
      }
    }
}

// The q-tile walk of one kv tile, shared by K7 and K8 (bf16), on the
// transposed tiles: each warp owns 16 keys; S^T = K Q^T and dP^T = V dO^T
// put the keys on the accumulator rows, so round(P^T) and round(dS^T) are
// A fragments for dV += P^T dO and dK += dS^T Q. The caller has staged the
// kv tile and q tile `first` into buffer 0 and committed. With FUSED, each
// pair's round(dS) also goes to shared memory in (q, key) order, and each
// warp adds round(dS) K for its 16 query rows into the f32 scratch acc
// ((s_q, d) rows of this head; the first kv tile stores). The thread that
// writes a scratch element is the same for every kv tile.
template <int HD, bool FUSED>
__device__ __forceinline__ void mma_dkv_walk(
    float (&acc_k)[HD / 8][4], float (&acc_v)[HD / 8][4], const bf16* q,
    const bf16* dout, const float* lse, const float* delta, float* acc,
    unsigned char* smem, long long qrow0, int j0, int first, bool first_kv,
    int s_q, int s_k, int d, float scale, int causal, bool vec,
    const Strides& st) {
  constexpr int TILE = kRows * (HD + 8);
  constexpr int LDS = kRows + 8;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + TILE;
  bf16* sq = sv + TILE;       // two buffers
  bf16* sdo = sq + 2 * TILE;  // two buffers
  float* slse = reinterpret_cast<float*>(sdo + 2 * TILE);  // two buffers
  float* sdl = slse + 2 * kRows;                           // two buffers
  bf16* sds = reinterpret_cast<bf16*>(sdl + 2 * kRows);    // K8: [q][key]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int g = lane >> 2;
  const int k_lo = j0 + warp * 16 + g;  // this thread's two keys
  const int k_hi = k_lo + 8;
  const int nq = (s_q + kRows - 1) / kRows;

  for (int it = first; it < nq; ++it) {
    const int buf = (it - first) & 1;
    const bool more = it + 1 < nq;
    if (more) {  // the next q tile into the other buffer, read a tile ago
      const int in = (it + 1) * kRows;
      const int nb = buf ^ 1;
      stage<HD>(sq + nb * TILE, q + qrow0 + in * st.qr, st.qr, s_q - in, d,
                vec);
      stage<HD>(sdo + nb * TILE, dout + qrow0 + in * st.qr, st.qr,
                s_q - in, d, vec);
      for (int r = threadIdx.x; r < kRows; r += kThreads) {
        const bool ok = in + r < s_q;
        slse[nb * kRows + r] = ok ? lse[in + r] : 0.f;
        sdl[nb * kRows + r] = ok ? delta[in + r] : 0.f;
      }
      if (vec) cp_async_commit();
    }
    stage_wait(vec, more);
    __syncthreads();
    const bf16* qt = sq + buf * TILE;
    const bf16* dot = sdo + buf * TILE;
    const float* tl = slse + buf * kRows;
    const float* td = sdl + buf * kRows;
    float st_[kTileN][4], dpt[kTileN][4];
    scores<HD>(st_, sk, qt, warp * 16);   // S^T = K Q^T
    scores<HD>(dpt, sv, dot, warp * 16);  // dP^T = V dO^T
    const int i0 = it * kRows;
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = j * 8 + 2 * t + c;  // the query row in the tile
        const float l_q = tl[r];
        const float d_q = td[r];
        // padded q rows are masked out of p (mask_q_rows)
        const float p_lo = live(i0 + r, k_lo, s_q, s_k, causal)
                               ? expf(st_[j][c] * scale - l_q) : 0.f;
        const float p_hi = live(i0 + r, k_hi, s_q, s_k, causal)
                               ? expf(st_[j][2 + c] * scale - l_q) : 0.f;
        st_[j][c] = p_lo;
        st_[j][2 + c] = p_hi;
        dpt[j][c] = p_lo * (dpt[j][c] - d_q) * scale;  // ds^T
        dpt[j][2 + c] = p_hi * (dpt[j][2 + c] - d_q) * scale;
        if (FUSED) {
          sds[r * LDS + warp * 16 + g] = __float2bfloat16(dpt[j][c]);
          sds[r * LDS + warp * 16 + g + 8] = __float2bfloat16(dpt[j][2 + c]);
        }
      }
    accumulate_pb<HD>(acc_v, st_, dot);  // dV += round(P^T) dO
    accumulate_pb<HD>(acc_k, dpt, qt);   // dK += round(dS^T) Q
    if (FUSED) {
      __syncthreads();  // the pair's dS is in shared memory
      const int q_lo = i0 + warp * 16 + g;  // this thread's two query rows
      const int q_hi = q_lo + 8;
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          uint32_t a[4], bb[4];
          frag_a(a, sds, LDS, warp * 16, kk * 16);
          frag_b_kn(bb, sk, HD + 8, kk * 16, np * 16);
          mma(o[0], a, bb[0], bb[1]);  // dQ += round(dS) K
          mma(o[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = np * 16 + nt * 8 + 2 * t + c;
            if (col < d) {
              if (q_lo < s_q) {
                float* p = acc + (long long)q_lo * d + col;
                *p = (first_kv ? 0.f : *p) + o[nt][c];
              }
              if (q_hi < s_q) {
                float* p = acc + (long long)q_hi * d + col;
                *p = (first_kv ? 0.f : *p) + o[nt][2 + c];
              }
            }
          }
      }
    }
    __syncthreads();  // every warp is done with this buffer (and dS)
  }
}

// stage kv tile j0 (k, v) and q tile `first` (q, dO, lse, delta rows)
// into buffer 0, committed
template <int HD>
__device__ __forceinline__ void mma_stage_pair(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, unsigned char* smem,
    long long qrow0, long long krow0, int j0, int first, int s_q, int s_k,
    int d, bool vec, const Strides& st) {
  constexpr int TILE = kRows * (HD + 8);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + TILE;
  bf16* sq = sv + TILE;
  bf16* sdo = sq + 2 * TILE;
  float* slse = reinterpret_cast<float*>(sdo + 2 * TILE);
  float* sdl = slse + 2 * kRows;
  const int i0 = first * kRows;
  stage<HD>(sk, k + krow0 + j0 * st.kr, st.kr, s_k - j0, d, vec);
  stage<HD>(sv, v + krow0 + j0 * st.kr, st.kr, s_k - j0, d, vec);
  stage<HD>(sq, q + qrow0 + i0 * st.qr, st.qr, s_q - i0, d, vec);
  stage<HD>(sdo, dout + qrow0 + i0 * st.qr, st.qr, s_q - i0, d, vec);
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool ok = i0 + r < s_q;
    slse[r] = ok ? lse[i0 + r] : 0.f;
    sdl[r] = ok ? delta[i0 + r] : 0.f;
  }
  if (vec) cp_async_commit();
}

// the kv tile's dK and dV rows from this thread's accumulator fragments
template <int HD>
__device__ __forceinline__ void mma_store_dkv(
    bf16* dk, bf16* dv, const float (&acc_k)[HD / 8][4],
    const float (&acc_v)[HD / 8][4], long long krow0, int j0, int s_k,
    int d, const Strides& st) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int k_lo = j0 + warp * 16 + (lane >> 2);
  const int k_hi = k_lo + 8;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n * 8 + 2 * t + c;
      if (col < d) {
        if (k_lo < s_k) {
          const long long o = krow0 + k_lo * st.kr + col;
          dk[o] = __float2bfloat16(acc_k[n][c]);
          dv[o] = __float2bfloat16(acc_v[n][c]);
        }
        if (k_hi < s_k) {
          const long long o = krow0 + k_hi * st.kr + col;
          dk[o] = __float2bfloat16(acc_k[n][2 + c]);
          dv[o] = __float2bfloat16(acc_v[n][2 + c]);
        }
      }
    }
}

template <int HD>
__device__ __forceinline__ void zero(float (&a)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[n][c] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int heads, int s_q, int s_k, int d,
                  float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  const int j0 = blockIdx.x * kRows;  // the first kv tiles see the most rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long stat = ((long long)b * heads + h) * s_q;
  // the first q tile with a row that sees key j0 under the causal mask
  const int first = first_row(j0, s_q, s_k, causal) / kRows;
  mma_stage_pair<HD>(q, k, v, dout, lse + stat, delta + stat, ff_smem,
                     qrow0, krow0, j0, first, s_q, s_k, d, vec, st);
  float acc_k[HD / 8][4], acc_v[HD / 8][4];
  zero<HD>(acc_k);
  zero<HD>(acc_v);
  mma_dkv_walk<HD, false>(acc_k, acc_v, q, dout, lse + stat, delta + stat,
                          nullptr, ff_smem, qrow0, j0, first, false, s_q,
                          s_k, d, scale, causal, vec, st);
  mma_store_dkv<HD>(dk, dv, acc_k, acc_v, krow0, j0, s_k, d, st);
}

// K8, bf16: one block per (b, h) walks every kv tile
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ dq_acc, int heads, int s_q, int s_k,
                    int d, float scale, int causal, int vec, Strides st) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long qrow0 = b * st.qb + h * st.qh;
  const long long krow0 = b * st.kb + h * st.kh;
  const long long stat = ((long long)b * heads + h) * s_q;
  float* acc = dq_acc + stat * d;
  const int nk = (s_k + kRows - 1) / kRows;
  for (int jt = 0; jt < nk; ++jt) {
    const int j0 = jt * kRows;
    const int first = first_row(j0, s_q, s_k, causal) / kRows;
    // the last walk ended in a sync with no copy pending
    mma_stage_pair<HD>(q, k, v, dout, lse + stat, delta + stat, ff_smem,
                       qrow0, krow0, j0, first, s_q, s_k, d, vec, st);
    float acc_k[HD / 8][4], acc_v[HD / 8][4];
    zero<HD>(acc_k);
    zero<HD>(acc_v);
    // the first kv tile walks every q tile: it stores each scratch row
    mma_dkv_walk<HD, true>(acc_k, acc_v, q, dout, lse + stat, delta + stat,
                           acc, ff_smem, qrow0, j0, first, jt == 0, s_q, s_k,
                           d, scale, causal, vec, st);
    mma_store_dkv<HD>(dk, dv, acc_k, acc_v, krow0, j0, s_k, d, st);
  }
  __syncthreads();  // every scratch row of this head is summed
  for (int idx = threadIdx.x; idx < s_q * d; idx += kThreads)
    dq[qrow0 + (idx / d) * st.qr + idx % d] = __float2bfloat16(acc[idx]);
}

// ====================================================== launch

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // out | dq | dk (K7)
  void* out1;  // dv (K7) | dk (K8)
  void* out2;  // dv (K8)
  float* scratch;  // K8's f32 dq rows, (b, h, s_q, d)
  float* lse_out;
  int batch, heads, s_q, s_k, d;
  Strides st;
  float scale;
  int causal;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kFused = 3 };

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Opt a kernel into more than 48 KB of dynamic shared memory.
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

template <int HD>
int launch_f32(Which which, const Args& a, int vec, cudaStream_t stream) {
  const int nq = (a.s_q + kRowsF32 - 1) / kRowsF32;
  const int nk = (a.s_k + kRowsF32 - 1) / kRowsF32;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  if (which == kFwd) {
    FF_LAUNCH(flash_fwd_f32<HD>, F32Fwd<HD>::bytes,
              dim3(nq, a.heads, a.batch), q, k, v,
              static_cast<float*>(a.out0), a.lse_out, a.heads, a.s_q, a.s_k,
              a.d, a.scale, a.causal, vec, a.st);
  } else if (which == kDq) {
    FF_LAUNCH(flash_bwd_dq_f32<HD>, F32Bwd<HD>::bytes,
              dim3(nq, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<float*>(a.out0), a.heads, a.s_q, a.s_k, a.d,
              a.scale, a.causal, vec, a.st);
  } else if (which == kDkv) {
    FF_LAUNCH(flash_bwd_dkv_f32<HD>, F32Bwd<HD>::bytes,
              dim3(nk, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<float*>(a.out0), static_cast<float*>(a.out1),
              a.heads, a.s_q, a.s_k, a.d, a.scale, a.causal, vec, a.st);
  } else {
    FF_LAUNCH(flash_bwd_fused_f32<HD>, F32Bwd<HD>::bytes,
              dim3(a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<float*>(a.out0), static_cast<float*>(a.out1),
              static_cast<float*>(a.out2), a.scratch, a.heads, a.s_q, a.s_k,
              a.d, a.scale, a.causal, vec, a.st);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(Which which, const Args& a, int vec, cudaStream_t stream) {
  const int nq = (a.s_q + kRows - 1) / kRows;
  const int nk = (a.s_k + kRows - 1) / kRows;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  if (which == kFwd) {
    FF_LAUNCH(flash_fwd_mma<HD>, MmaSmem<HD>::fwd,
              dim3(nq, a.heads, a.batch), q, k, v,
              static_cast<bf16*>(a.out0), a.lse_out, a.heads, a.s_q, a.s_k,
              a.d, a.scale, a.causal, vec, a.st);
  } else if (which == kDq) {
    FF_LAUNCH(flash_bwd_dq_mma<HD>, MmaSmem<HD>::dq,
              dim3(nq, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<bf16*>(a.out0), a.heads, a.s_q, a.s_k, a.d,
              a.scale, a.causal, vec, a.st);
  } else if (which == kDkv) {
    FF_LAUNCH(flash_bwd_dkv_mma<HD>, MmaSmem<HD>::dkv,
              dim3(nk, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
              a.heads, a.s_q, a.s_k, a.d, a.scale, a.causal, vec, a.st);
  } else {
    FF_LAUNCH(flash_bwd_fused_mma<HD>, MmaSmem<HD>::fused,
              dim3(a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
              static_cast<bf16*>(a.out2), a.scratch, a.heads, a.s_q, a.s_k,
              a.d, a.scale, a.causal, vec, a.st);
  }
  return (int)cudaGetLastError();
}

#undef FF_LAUNCH

template <int HD>
int launch_hd(Which which, const Args& a, int dtype, cudaStream_t stream) {
  const long long per = dtype == kF32 ? 4 : 8;  // elements in 16 bytes
  const Strides& s = a.st;
  // 16-byte row loads: no padded columns, and the start of every row of
  // every head 16-byte aligned
  const int vec = a.d == HD && s.qb % per == 0 && s.qh % per == 0 &&
                  s.qr % per == 0 && s.kb % per == 0 && s.kh % per == 0 &&
                  s.kr % per == 0 && aligned16(a.q) && aligned16(a.k) &&
                  aligned16(a.v) && (a.dout == nullptr || aligned16(a.dout));
  return dtype == kF32 ? launch_f32<HD>(which, a, vec, stream)
                       : launch_bf16<HD>(which, a, vec, stream);
}

int dispatch(Which which, const Args& a, int dtype, void* stream) {
  if (a.batch < 1 || a.heads < 1 || a.s_q < 1 || a.s_k < 1 || a.d < 1 ||
      a.d > 128 || a.batch > 65535 || a.heads > 65535)
    return -1;
  if (a.st.qb < 0 || a.st.qh < 0 || a.st.qr < 1 || a.st.kb < 0 ||
      a.st.kh < 0 || a.st.kr < 1)
    return -1;
  // causal rows with no live key are not taken (the entries route them
  // to sdpa_xla)
  if (a.causal && a.s_q > a.s_k) return -1;
  if (dtype != kF32 && dtype != kBF16) return -1;
  if (which == kFused && a.scratch == nullptr) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.d <= 32) return launch_hd<32>(which, a, dtype, st);
  if (a.d <= 64) return launch_hd<64>(which, a, dtype, st);
  return launch_hd<128>(which, a, dtype, st);
}

}  // namespace

// Plain C interface, bound by ctypes. Pointers are device pointers. q, out,
// dO and dq share the element strides (q_sb, q_sh, q_sr) of batch, head
// and row; k, v, dk and dv share (k_sb, k_sh, k_sr); the head dim is
// unit-stride. lse and delta are contiguous (b, h, s_q) f32; K8's scratch
// is b*h*s_q*head_dim f32. Each returns a cudaError_t code (0 = the launch
// was accepted), or -1 for a shape, stride or dtype it does not take.
#define FF_SHAPE_ARGS                                                     \
  int batch, int heads, int s_q, int s_k, int head_dim, long long q_sb,  \
      long long q_sh, long long q_sr, long long k_sb, long long k_sh,    \
      long long k_sr, float scale, int causal, int dtype, void *stream
#define FF_SHAPE                                                          \
  batch, heads, s_q, s_k, head_dim, {q_sb, q_sh, q_sr, k_sb, k_sh, k_sr}, \
      scale, causal

extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      FF_SHAPE_ARGS) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, nullptr,
         nullptr, lse, FF_SHAPE};
  return dispatch(kFwd, a, dtype, stream);
}

extern "C" int ff_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse,
                                         const float* delta, void* dq,
                                         FF_SHAPE_ARGS) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, nullptr,
         FF_SHAPE};
  return dispatch(kDq, a, dtype, stream);
}

extern "C" int ff_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse,
                                          const float* delta, void* dk,
                                          void* dv, FF_SHAPE_ARGS) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr, nullptr,
         FF_SHAPE};
  return dispatch(kDkv, a, dtype, stream);
}

extern "C" int ff_flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    float* scratch, FF_SHAPE_ARGS) {
  Args a{q, k, v, dout, lse, delta, dq, dk, dv, scratch, nullptr, FF_SHAPE};
  return dispatch(kFused, a, dtype, stream);
}
