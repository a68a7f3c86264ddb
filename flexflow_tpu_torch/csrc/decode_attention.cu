// Single-query decode attention over a KV cache, contiguous or paged.
//
// Replaces the TPU kernels
//   flexflow_tpu/kernels/flash_attention.py:_decode_kernel (1261), reached
//     through flash_decode_attention (1371)          -> K2, contiguous cache
//   flexflow_tpu/kernels/flash_attention.py:_paged_decode_kernel (1446),
//     reached through paged_flash_decode_attention (1539) -> K3, paged pool
//
// What it computes, per (slot s, head h): one query row q (hd values) over
// the slot's live keys [0, length[s]):
//   logit_j = (q . round(k_j)) * scale            (f32 accumulation)
//   out     = sum_j round(p_j) * round(v_j) / max(sum_j p_j, 1e-30)
// with p_j = exp(logit_j - max_j logit_j), round() = rounding to the compute
// dtype of q, and the output cast once to q's dtype. Keys past the cursor are
// never read: in the TPU kernel they are masked to -1e30 (exp -> exactly 0)
// and their V rows zeroed before P.V, so skipping them gives the same sums
// and a stale NaN in a dead row cannot reach the output. A slot with length
// 0 reads nothing and writes 0 (the 1e-30 clamp keeps it finite).
//
// The KV state rests in f32 while compute runs in bf16. The JAX op casts the
// whole pool to bf16 every layer and step; this kernel reads the f32 rows and
// rounds each element to the compute dtype as it loads it, which gives the
// same numbers with no pool-sized copy.
//
// The two layouts share one templated body. Only the map from a logical key
// row to an address differs: a contiguous row s*stride_outer + r*stride_row,
// or, through the page table, table[s, r / bs]*stride_outer +
// (r % bs)*stride_row. The block loads its own table entries: it stages the
// entries of its live logical blocks in shared memory before the key loop.
//
// Bound on the H100: bytes. Each live key costs 2*hd*4 bytes of f32 K and V
// per head and 2*hd flops per matrix product, about 0.5 flop per byte, far
// below the ~295 flops/byte where the tensor cores would become the limit.
// Design: one CUDA block of kWarps (8) warps per (slot, head); warps take the
// live keys in interleaved groups of kUnroll (loads of a group are issued
// before its math), each lane owns DPL dims of the head, a warp keeps its
// own online softmax (m, l, acc) in f32, and the block merges its warps
// through shared memory at the end. No tensor cores, no TMA: a plain,
// correct first kernel; a split-K or wgmma version is later work.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

// q dtype codes shared with the Python wrapper; the KV state is always f32
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// round a float to the compute dtype QT, and back to float
template <typename QT>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename QT>
__device__ __forceinline__ QT store_as(float x);
template <>
__device__ __forceinline__ float store_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, int DPL, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const QT* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ table, QT* __restrict__ out,
                        int head_dim, int embed, long long q_stride_slot,
                        long long stride_outer, long long stride_row,
                        int block_size, int table_width, int max_len,
                        int num_blocks, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // keys past the cache's extent do not exist: clamp the cursor to it
  const int length = min(max(lengths[s], 0), max_len);
  const long long col = (long long)h * head_dim;

  // PAGED: the block first stages the table entries of its live logical
  // blocks in shared memory (the TPU kernel scalar-prefetches the table),
  // so a key row's address costs no dependent global load. An entry outside
  // the pool is a corrupt table: the kernel stops with a device assert, as
  // the plain version's gather raises, rather than read another block.
  extern __shared__ int sm_table[];
  if (PAGED) {
    const int nblk = (length + block_size - 1) / block_size;
    for (int i = threadIdx.x; i < nblk; i += blockDim.x) {
      const int phys = __ldg(table + (long long)s * table_width + i);
      assert(phys >= 0 && phys < num_blocks);
      sm_table[i] = phys;
    }
    __syncthreads();
  }

  // this lane's dims of q, in the compute dtype
  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < head_dim ? load_f(q + s * q_stride_slot + col + d) : 0.f;
  }

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int j0 = warp * kUnroll; j0 < length; j0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL];
    float vr[kUnroll][DPL];
    // issue every load of the group before any math
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = j0 + u;
      long long row = 0;
      if (r < length) {
        if (PAGED) {
          row = (long long)sm_table[r / block_size] * stride_outer +
                (long long)(r % block_size) * stride_row;
        } else {
          row = (long long)s * stride_outer + (long long)r * stride_row;
        }
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool ok = r < length && d < head_dim;
        kr[u][i] = ok ? load_f(k + row + col + d) : 0.f;
        vr[u][i] = ok ? load_f(v + row + col + d) : 0.f;
      }
    }
    float logit[kUnroll];
    float gmax = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qv[i] * round_to<QT>(kr[u][i]);
      logit[u] = warp_sum(part) * scale;
      if (j0 + u < length) gmax = fmaxf(gmax, logit[u]);
    }
    // j0 < length, so the group holds at least one live key: gmax is finite
    const float m_new = fmaxf(m, gmax);
    const float alpha = expf(m - m_new);  // m = -inf (first group) -> 0
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < length) {
        const float p = expf(logit[u] - m_new);
        l += p;
        const float pr = round_to<QT>(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pr * round_to<QT>(vr[u][i]);
      }
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DPL * 32];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  float big = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w]);
  float wt[kWarps];
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no key has m = -inf and l = acc = 0
    wt[w] = sm_m[w] == -CUDART_INF_F ? 0.f : expf(sm_m[w] - big);
    total += sm_l[w] * wt[w];
  }
  const float denom = fmaxf(total, 1e-30f);
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wt[w];
    out[(long long)s * embed + col + d] = store_as<QT>(a / denom);
  }
}

template <typename QT, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v,
                       const int* lengths, const int* table, void* out,
                       int slots, int heads, int head_dim, int embed,
                       long long q_stride_slot, long long stride_outer,
                       long long stride_row, int block_size, int table_width,
                       int max_len, int num_blocks, float scale,
                       cudaStream_t stream) {
  dim3 grid(slots, heads);
  dim3 block(kWarps * 32);
  if (table != nullptr) {
    const size_t smem = (size_t)table_width * sizeof(int);
    decode_attention_kernel<QT, DPL, true><<<grid, block, smem, stream>>>(
        (const QT*)q, (const float*)k, (const float*)v, lengths, table,
        (QT*)out,
        head_dim, embed, q_stride_slot, stride_outer, stride_row, block_size,
        table_width, max_len, num_blocks, scale);
  } else {
    decode_attention_kernel<QT, DPL, false><<<grid, block, 0, stream>>>(
        (const QT*)q, (const float*)k, (const float*)v, lengths, table,
        (QT*)out,
        head_dim, embed, q_stride_slot, stride_outer, stride_row, block_size,
        table_width, max_len, num_blocks, scale);
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_types(const void* q, const void* k, const void* v,
                         const int* lengths, const int* table, void* out,
                         int slots, int heads, int head_dim, int embed,
                         long long q_stride_slot, long long stride_outer,
                         long long stride_row, int block_size,
                         int table_width, int max_len, int num_blocks,
                         float scale, cudaStream_t stream) {
#define FF_LAUNCH(D)                                                        \
  return launch_dpl<QT, D>(q, k, v, lengths, table, out, slots, heads, \
                               head_dim, embed, q_stride_slot,             \
                               stride_outer, stride_row, block_size,       \
                               table_width, max_len, num_blocks, scale,   \
                               stream)
  if (head_dim <= 32) FF_LAUNCH(1);
  if (head_dim <= 64) FF_LAUNCH(2);
  if (head_dim <= 128) FF_LAUNCH(4);
  FF_LAUNCH(8);
#undef FF_LAUNCH
}

}  // namespace

// Plain C interface, bound by ctypes. Pointers are device pointers; `table`
// is null for the contiguous layout; k and v are f32. Returns a cudaError_t
// code (0 = the launch was accepted), or -1 for a q dtype or head size it
// does not take.
extern "C" int ff_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* table, void* out, int slots, int heads, int head_dim,
    int embed, long long q_stride_slot, long long stride_outer,
    long long stride_row, int block_size, int table_width, int max_len,
    int num_blocks, float scale, int q_dtype, void* stream) {
  if (head_dim < 1 || head_dim > 256 || slots < 1 || heads < 1) return -1;
  // the staged table must fit the default 48 KB of dynamic shared memory
  if (table != nullptr && (block_size < 1 || num_blocks < 1 ||
                           table_width < 1 || table_width > 12288))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_TYPES(QT)                                                         \
  return (int)launch_types<QT>(q, k, v, lengths, table, out, slots, heads,  \
                               head_dim, embed, q_stride_slot, stride_outer, \
                               stride_row, block_size, table_width, max_len, \
                               num_blocks, scale, st)
  if (q_dtype == kF32) FF_TYPES(float);
  if (q_dtype == kBF16) FF_TYPES(__nv_bfloat16);
#undef FF_TYPES
  return -1;
}
