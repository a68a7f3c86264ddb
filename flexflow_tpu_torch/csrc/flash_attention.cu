// Packed flash attention for training: the forward (K5) and the FA2
// backward split into dq (K6) and dk/dv (K7).
//
// Replaces the TPU kernels
//   flexflow_tpu/kernels/flash_attention.py:_flash_kernel_grouped (705),
//     pallas_call at 946, via _flash_fwd_packed_grouped (907)      -> K5
//   flexflow_tpu/kernels/flash_attention.py:_bwd_dq_kernel_grouped (808),
//     pallas_call at 1045, via _flash_bwd_packed_grouped (1021)    -> K6
//   flexflow_tpu/kernels/flash_attention.py:_bwd_dkv_kernel_grouped (854),
//     pallas_call at 1064, via _flash_bwd_packed_grouped (1021)    -> K7
// reached from flash_attention_packed (1212) through the _flash_packed
// custom VJP (1189).
//
// Layout: q, k, v, out and the gradients are (b, s, h*d), the projections'
// own layout; head h of row i lives at [i*e + h*d, i*e + h*d + d) with
// e = h*d. There is no head transpose. The TPU path groups narrow heads
// into 128-lane stripes; on a GPU a block addresses one head directly, so
// one kernel serves every head width up to 128 (templated on the head dim
// padded to 32, 64 or 128 with zero columns, which change no product).
// lse and delta are (b, h, s) f32 (the TPU keeps 128 lanes of copies).
//
// What K5 computes, per (b, h) and query row i over keys j < s_k:
//   logit_ij = (q_i . k_j) * scale        (f32 accumulation, then scale)
//   masked logits (causal: i + s_k - s_q < j) are -1e30, the TPU NEG_INF
//   online softmax over key tiles in f32: m, l = sum p, and
//   acc += round(p) . v with p rounded to v's dtype before the product
//   out = acc / l, cast once;  lse = m + log(l)
// Tiles entirely above the causal diagonal are skipped; rows past s_k are
// zero-filled in shared memory, so padded V rows are zero as in the TPU
// kernel. JAX runs lm-base's seq 512 in one 512-key pass (one-pass
// softmax); the tiled online softmax here differs from it only where p is
// rounded to bf16 (against the running instead of the final row max).
// Causal attention with s_q > s_k (rows with no live key) is refused by
// the wrapper: the JAX package routes that shape to sdpa_xla.
//
// K6 and K7 recompute p = exp(logit - lse) (0 where masked) and
//   ds = p * (dp - delta) * scale,  dp = dO . v,  delta = rowsum(dO * O)
// (_bwd_tile_math, 277-333). K6, one block per (b, h, q tile), walks the
// live kv tiles: dq += round(ds) . k. K7, one block per (b, h, kv tile),
// walks the q tiles from the diagonal down: dv += round(p)^T . dO and
// dk += round(ds)^T . q, with padded q rows masked out of p. Each output
// is cast once. No atomics: every output element has one writer, so
// results do not change from run to run.
//
// Bound on the H100 at lm-base's shapes (b 8, s 512, 16 heads of 64,
// bf16): bytes. K5 reads q, k, v and writes out (34 MB), K6 reads q, k, v,
// dO, lse, delta and writes dq (~42 MB), K7 reads the same and writes dk,
// dv (~50 MB): 10-15 us each at 3.35 TB/s, against 2-6 us of causal
// tensor-core work at 989 TFLOP/s.
//
// Design, bf16 (the training path): FlashAttention-2's. Four warps per
// block, each owning 16 rows of the block's 64-row tile (query rows for K5
// and K6, key rows for K7). The tile of the streamed operand (K and V for
// K5 and K6; Q and dO for K7) is double-buffered in shared memory with
// cp.async, so the next tile's loads overlap this tile's math. Products
// run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with operands read by
// ldmatrix; S, P, dP, dS and the accumulators never leave registers: the
// f32 accumulator fragment of S is the bf16 A fragment of P after
// rounding, so P.V needs no shared-memory round trip, and K7 works on the
// transposed tiles (K.Q^T, V.dO^T) so that dV and dK accumulate the same
// way. Row statistics reduce across the four lanes of a row (quad
// shuffles).
//
// Design, f32 (parity checks and f32 training): full f32 on SIMT FMAs (the
// port turns TF32 off and the f32 checks rely on it), 32-row tiles with
// every intermediate in shared memory, a sync between passes. A plain
// correct kernel.
//
// TMA, wgmma and warp specialisation are later work.

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

// K6 and K7: q, dO, k, v tiles, S (P in place), dP (dS in place), two
// accumulators (K6 uses one), per-row lse and delta
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
  static constexpr size_t lse = align128(acc1 + L::kTileO);
  static constexpr size_t delta = align128(lse + L::kRowsF);
  static constexpr size_t bytes = align128(delta + L::kRowsF);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int heads, int s_q, int s_k, int d,
              float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  using S = F32Fwd<HD>;
  constexpr int BR = S::BR;
  const int e = heads * d;
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

  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + (long long)i0 * e, e,
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
    load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + (long long)j0 * e, e,
                             min(BR, s_k - j0), d, vec);
    load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + (long long)j0 * e, e,
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
      out[qrow0 + (long long)(i0 + r) * e + c] = so[r * S::LDO + c] / sl[r];
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
                 int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  const int e = heads * d;
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

  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  const long long row_stat = ((long long)b * heads + h) * s_q;
  const int rows = min(BR, s_q - i0);
  load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + (long long)i0 * e, e,
                           rows, d, vec);
  load_tile<float, BR, HD>(sdo, S::LDT, dout + qrow0 + (long long)i0 * e, e,
                           rows, d, vec);
  load_rows(slse, lse + row_stat, i0, BR, s_q);
  load_rows(sdelta, delta + row_stat, i0, BR, s_q);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads)
    sdq[(idx / HD) * S::LDO + idx % HD] = 0.f;

  const int nkv = (kv_end(i0, BR, s_q, s_k, causal) + BR - 1) / BR;
  for (int jt = 0; jt < nkv; ++jt) {
    const int j0 = jt * BR;
    __syncthreads();
    load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + (long long)j0 * e, e,
                             min(BR, s_k - j0), d, vec);
    load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + (long long)j0 * e, e,
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
      dq[qrow0 + (long long)(i0 + r) * e + c] = sdq[r * S::LDO + c];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int heads, int s_q, int s_k, int d,
                  float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  using S = F32Bwd<HD>;
  constexpr int BR = S::BR;
  const int e = heads * d;
  const int j0 = blockIdx.x * BR;  // the first kv tiles see the most q rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  float* sq = reinterpret_cast<float*>(ff_smem + S::q);
  float* sdo = reinterpret_cast<float*>(ff_smem + S::dout);
  float* sk = reinterpret_cast<float*>(ff_smem + S::k);
  float* sv = reinterpret_cast<float*>(ff_smem + S::v);
  float* ss = reinterpret_cast<float*>(ff_smem + S::s);
  float* sdp = reinterpret_cast<float*>(ff_smem + S::dp);
  float* sdk = reinterpret_cast<float*>(ff_smem + S::acc0);
  float* sdv = reinterpret_cast<float*>(ff_smem + S::acc1);
  float* slse = reinterpret_cast<float*>(ff_smem + S::lse);
  float* sdelta = reinterpret_cast<float*>(ff_smem + S::delta);

  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  const long long row_stat = ((long long)b * heads + h) * s_q;
  const int krows = min(BR, s_k - j0);
  load_tile<float, BR, HD>(sk, S::LDT, k + krow0 + (long long)j0 * e, e,
                           krows, d, vec);
  load_tile<float, BR, HD>(sv, S::LDT, v + krow0 + (long long)j0 * e, e,
                           krows, d, vec);
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int o = (idx / HD) * S::LDO + idx % HD;
    sdk[o] = 0.f;
    sdv[o] = 0.f;
  }

  // the first q row that sees key j0 under the causal mask
  const int first = causal ? max(0, j0 - (s_k - s_q)) : 0;
  const int nq = (s_q + BR - 1) / BR;
  for (int it = first / BR; it < nq; ++it) {
    const int i0 = it * BR;
    const int rows = min(BR, s_q - i0);
    __syncthreads();
    load_tile<float, BR, HD>(sq, S::LDT, q + qrow0 + (long long)i0 * e, e,
                             rows, d, vec);
    load_tile<float, BR, HD>(sdo, S::LDT, dout + qrow0 + (long long)i0 * e,
                             e, rows, d, vec);
    load_rows(slse, lse + row_stat, i0, BR, s_q);
    load_rows(sdelta, delta + row_stat, i0, BR, s_q);
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
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BR * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx % HD;
    if (r < krows && c < d) {
      const long long o = krow0 + (long long)(j0 + r) * e + c;
      dk[o] = sdk[r * S::LDO + c];
      dv[o] = sdv[r * S::LDO + c];
    }
  }
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
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ lse, int heads, int s_q, int s_k, int d,
              float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int TILE = kRows * (HD + 8);
  bf16* sq = reinterpret_cast<bf16*>(ff_smem);
  bf16* sk = sq + TILE;      // two buffers
  bf16* sv = sk + 2 * TILE;  // two buffers
  const int e = heads * d;
  const int nq = (s_q + kRows - 1) / kRows;
  const int i0 = (nq - 1 - blockIdx.x) * kRows;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  const int r_lo = i0 + warp * 16 + (lane >> 2);  // this thread's two rows
  const int r_hi = r_lo + 8;

  stage<HD>(sq, q + qrow0 + (long long)i0 * e, e, s_q - i0, d, vec);
  stage<HD>(sk, k + krow0, e, s_k, d, vec);
  stage<HD>(sv, v + krow0, e, s_k, d, vec);
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
      stage<HD>(sk + (buf ^ 1) * TILE, k + krow0 + (long long)jn * e, e,
                s_k - jn, d, vec);
      stage<HD>(sv + (buf ^ 1) * TILE, v + krow0 + (long long)jn * e, e,
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
          out[qrow0 + (long long)r_lo * e + col] =
              __float2bfloat16(o[n][c] / l_lo);
        if (r_hi < s_q)
          out[qrow0 + (long long)r_hi * e + col] =
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
                 int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int TILE = kRows * (HD + 8);
  bf16* sq = reinterpret_cast<bf16*>(ff_smem);
  bf16* sdo = sq + TILE;
  bf16* sk = sdo + TILE;     // two buffers
  bf16* sv = sk + 2 * TILE;  // two buffers
  const int e = heads * d;
  const int nq = (s_q + kRows - 1) / kRows;
  const int i0 = (nq - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * s_q;
  const int r_lo = i0 + warp * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;

  stage<HD>(sq, q + qrow0 + (long long)i0 * e, e, s_q - i0, d, vec);
  stage<HD>(sdo, dout + qrow0 + (long long)i0 * e, e, s_q - i0, d, vec);
  stage<HD>(sk, k + krow0, e, s_k, d, vec);
  stage<HD>(sv, v + krow0, e, s_k, d, vec);
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
      stage<HD>(sk + (buf ^ 1) * TILE, k + krow0 + (long long)jn * e, e,
                s_k - jn, d, vec);
      stage<HD>(sv + (buf ^ 1) * TILE, v + krow0 + (long long)jn * e, e,
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
          dq[qrow0 + (long long)r_lo * e + col] = __float2bfloat16(acc[n][c]);
        if (r_hi < s_q)
          dq[qrow0 + (long long)r_hi * e + col] =
              __float2bfloat16(acc[n][2 + c]);
      }
    }
}

// K7 on the transposed tiles: each warp owns 16 keys; S^T = K Q^T and
// dP^T = V dO^T put the keys on the accumulator rows, so round(P^T) and
// round(dS^T) are A fragments for dV += P^T dO and dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int heads, int s_q, int s_k, int d,
                  float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  constexpr int TILE = kRows * (HD + 8);
  bf16* sk = reinterpret_cast<bf16*>(ff_smem);
  bf16* sv = sk + TILE;
  bf16* sq = sv + TILE;       // two buffers
  bf16* sdo = sq + 2 * TILE;  // two buffers
  float* slse = reinterpret_cast<float*>(sdo + 2 * TILE);  // two buffers
  float* sdl = slse + 2 * kRows;                           // two buffers
  const int e = heads * d;
  const int j0 = blockIdx.x * kRows;  // the first kv tiles see the most rows
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long qrow0 = (long long)b * s_q * e + (long long)h * d;
  const long long krow0 = (long long)b * s_k * e + (long long)h * d;
  const long long stat = ((long long)b * heads + h) * s_q;
  const int k_lo = j0 + warp * 16 + (lane >> 2);  // this thread's two keys
  const int k_hi = k_lo + 8;

  // q tile `it` (its q and dO rows, lse and delta) into buffer `buf`
  auto stage_q = [&](int it, int buf) {
    const int i0 = it * kRows;
    stage<HD>(sq + buf * TILE, q + qrow0 + (long long)i0 * e, e, s_q - i0,
              d, vec);
    stage<HD>(sdo + buf * TILE, dout + qrow0 + (long long)i0 * e, e,
              s_q - i0, d, vec);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool ok = i0 + r < s_q;
      slse[buf * kRows + r] = ok ? lse[stat + i0 + r] : 0.f;
      sdl[buf * kRows + r] = ok ? delta[stat + i0 + r] : 0.f;
    }
  };
  // the first q tile with a row that sees key j0 under the causal mask
  const int first = (causal ? max(0, j0 - (s_k - s_q)) : 0) / kRows;
  const int nq = (s_q + kRows - 1) / kRows;
  stage<HD>(sk, k + krow0 + (long long)j0 * e, e, s_k - j0, d, vec);
  stage<HD>(sv, v + krow0 + (long long)j0 * e, e, s_k - j0, d, vec);
  stage_q(first, 0);
  if (vec) cp_async_commit();

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc_k[n][c] = 0.f;
      acc_v[n][c] = 0.f;
    }

  for (int it = first; it < nq; ++it) {
    const int buf = (it - first) & 1;
    const bool more = it + 1 < nq;
    if (more) {  // the next q tile into the other buffer, read a tile ago
      stage_q(it + 1, buf ^ 1);
      if (vec) cp_async_commit();
    }
    stage_wait(vec, more);
    __syncthreads();
    const bf16* qt = sq + buf * TILE;
    const bf16* dot = sdo + buf * TILE;
    const float* tl = slse + buf * kRows;
    const float* td = sdl + buf * kRows;
    float st[kTileN][4], dpt[kTileN][4];
    scores<HD>(st, sk, qt, warp * 16);    // S^T = K Q^T
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
                               ? expf(st[j][c] * scale - l_q) : 0.f;
        const float p_hi = live(i0 + r, k_hi, s_q, s_k, causal)
                               ? expf(st[j][2 + c] * scale - l_q) : 0.f;
        st[j][c] = p_lo;
        st[j][2 + c] = p_hi;
        dpt[j][c] = p_lo * (dpt[j][c] - d_q) * scale;  // ds^T
        dpt[j][2 + c] = p_hi * (dpt[j][2 + c] - d_q) * scale;
      }
    accumulate_pb<HD>(acc_v, st, dot);  // dV += round(P^T) dO
    accumulate_pb<HD>(acc_k, dpt, qt);  // dK += round(dS^T) Q
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n * 8 + 2 * t + c;
      if (col < d) {
        if (k_lo < s_k) {
          const long long o = krow0 + (long long)k_lo * e + col;
          dk[o] = __float2bfloat16(acc_k[n][c]);
          dv[o] = __float2bfloat16(acc_v[n][c]);
        }
        if (k_hi < s_k) {
          const long long o = krow0 + (long long)k_hi * e + col;
          dk[o] = __float2bfloat16(acc_k[n][2 + c]);
          dv[o] = __float2bfloat16(acc_v[n][2 + c]);
        }
      }
    }
}

// ====================================================== launch

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // out | dq | dk
  void* out1;  // dv
  float* lse_out;
  int batch, heads, s_q, s_k, d;
  float scale;
  int causal;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

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
              a.d, a.scale, a.causal, vec);
  } else if (which == kDq) {
    FF_LAUNCH(flash_bwd_dq_f32<HD>, F32Bwd<HD>::bytes,
              dim3(nq, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<float*>(a.out0), a.heads, a.s_q, a.s_k, a.d,
              a.scale, a.causal, vec);
  } else {
    FF_LAUNCH(flash_bwd_dkv_f32<HD>, F32Bwd<HD>::bytes,
              dim3(nk, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<float*>(a.out0), static_cast<float*>(a.out1),
              a.heads, a.s_q, a.s_k, a.d, a.scale, a.causal, vec);
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
              a.d, a.scale, a.causal, vec);
  } else if (which == kDq) {
    FF_LAUNCH(flash_bwd_dq_mma<HD>, MmaSmem<HD>::dq,
              dim3(nq, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<bf16*>(a.out0), a.heads, a.s_q, a.s_k, a.d,
              a.scale, a.causal, vec);
  } else {
    FF_LAUNCH(flash_bwd_dkv_mma<HD>, MmaSmem<HD>::dkv,
              dim3(nk, a.heads, a.batch), q, k, v, dout, a.lse_in, a.delta,
              static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
              a.heads, a.s_q, a.s_k, a.d, a.scale, a.causal, vec);
  }
  return (int)cudaGetLastError();
}

#undef FF_LAUNCH

template <int HD>
int launch_hd(Which which, const Args& a, int dtype, cudaStream_t stream) {
  const int per = dtype == kF32 ? 4 : 8;  // elements in 16 bytes
  const int e = a.heads * a.d;
  // 16-byte row loads: no padded columns and every row start aligned
  const int vec = a.d == HD && e % per == 0 && aligned16(a.q) &&
                  aligned16(a.k) && aligned16(a.v) &&
                  (a.dout == nullptr || aligned16(a.dout));
  return dtype == kF32 ? launch_f32<HD>(which, a, vec, stream)
                       : launch_bf16<HD>(which, a, vec, stream);
}

int dispatch(Which which, const Args& a, int dtype, void* stream) {
  if (a.batch < 1 || a.heads < 1 || a.s_q < 1 || a.s_k < 1 || a.d < 1 ||
      a.d > 128 || a.batch > 65535 || a.heads > 65535)
    return -1;
  // causal rows with no live key are not taken (the wrapper refuses them)
  if (a.causal && a.s_q > a.s_k) return -1;
  if (dtype != kF32 && dtype != kBF16) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.d <= 32) return launch_hd<32>(which, a, dtype, st);
  if (a.d <= 64) return launch_hd<64>(which, a, dtype, st);
  return launch_hd<128>(which, a, dtype, st);
}

}  // namespace

// Plain C interface, bound by ctypes. Pointers are device pointers to
// contiguous tensors: q, out, dO, dq (b, s_q, h*d); k, v, dk, dv
// (b, s_k, h*d); lse, delta (b, h, s_q) f32. Each returns a cudaError_t code
// (0 = the launch was accepted), or -1 for a shape or dtype it does not take.
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int batch, int heads, int s_q, int s_k,
                                      int head_dim, float scale, int causal,
                                      int dtype, void* stream) {
  Args a{q,     k,   v,     nullptr, nullptr, nullptr, out,      nullptr,
         lse,   batch, heads, s_q,   s_k,     head_dim, scale,   causal};
  return dispatch(kFwd, a, dtype, stream);
}

extern "C" int ff_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int batch, int heads,
    int s_q, int s_k, int head_dim, float scale, int causal, int dtype,
    void* stream) {
  Args a{q,     k,     v,     dout, lse,      delta, dq,     nullptr,
         nullptr, batch, heads, s_q, s_k, head_dim, scale, causal};
  return dispatch(kDq, a, dtype, stream);
}

extern "C" int ff_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int batch,
    int heads, int s_q, int s_k, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  Args a{q,     k,     v,     dout, lse,      delta, dk,     dv,
         nullptr, batch, heads, s_q, s_k, head_dim, scale, causal};
  return dispatch(kDkv, a, dtype, stream);
}
