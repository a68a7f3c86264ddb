// Single-query decode attention over a KV cache: contiguous (K2) or paged
// (K3).
//
// Replaces the TPU kernels
//   flexflow_tpu/kernels/flash_attention.py:_decode_kernel (1261), reached
//     through flash_decode_attention (1371)          -> K2, contiguous cache
//   flexflow_tpu/kernels/flash_attention.py:_paged_decode_kernel (1446),
//     reached through paged_flash_decode_attention (1539) -> K3, paged pool
//
// What they compute, per (slot s, head h): one query row q (hd values) over
// the slot's live keys [0, length[s]):
//   logit_j = (q . round(k_j)) * scale            (f32 accumulation)
//   out     = sum_j round(p_j) * round(v_j) / max(sum_j p_j, 1e-30)
// with p_j = exp(logit_j - m), m a maximum of the logits the sum has seen
// (the kernels' blocks of keys differ from the TPU kernel's, so p is
// rounded against another m: a bf16 step at most), round() = rounding to
// the compute dtype of q, and the output cast once to q's dtype. Keys past
// the cursor are never read: in the TPU kernel they are masked to -1e30
// (exp -> exactly 0) and their V rows zeroed before P.V, so skipping them
// gives the same sums and a stale NaN in a dead row cannot reach the
// output. A slot with length 0 reads nothing and writes 0.
//
// The KV state rests in f32 while compute runs in bf16. The JAX op casts the
// whole pool to bf16 every layer and step; these kernels read the f32 rows
// and round each element to the compute dtype as they read it, which gives
// the same numbers with no pool-sized copy.
//
// Bound on the H100: bytes. Each live key costs 2*hd*4 bytes of f32 K and V
// per head and 2*hd flops per matrix product, about 0.5 flop per byte, far
// below the ~295 flops/byte where the tensor cores would become the limit
// (lm-base serving, 8 slots of 16 heads of 64, phase 8's lengths: 1245 live
// keys, 10.2 MB, 3.05 us).
//
// K2 design: one CUDA block of kWarps (8) warps per (slot, head); warps
// take the live keys in interleaved groups of kUnroll (loads of a group are
// issued before its math), each lane owns DPL dims of the head, a warp
// keeps its own online softmax (m, l, acc) in f32, and the block merges its
// warps through shared memory at the end.
//
// K3 design (split-K): one CTA of 128 threads per (split, head, slot), a
// split being a fixed run of keys_per_split logical keys (whole pages
// where a page is no wider than the split: 32 keys, 2 pages of 16, at
// head_dim 64), so a long slot spreads over many SMs instead of setting
// the time alone. The grid comes from shapes only (the wrapper's
// paged_decode_geometry): the host never reads the lengths, and a split
// past its slot's cursor exits at once. A split reads each of its pages'
// physical block once, by one thread, while its slot's length is on its
// way (one memory round trip for both), checks the live ones against the
// pool (a device assert), and lays out their rows' offsets with no per-key
// division;
// then every live K row and V row of the split goes to shared memory as
// asynchronous copies (16-byte cp.async where head_dim and the pool's
// strides allow, 4-byte otherwise), all in flight at once in two groups (K,
// then V). The logits (a warp per key, four keys' shuffle sums
// interleaved) wait only for K; warp 0 takes the
// split's max m, p = exp(logit - m), l and round(p); P.V (a thread per
// dim) waits for V. A slot with one live split writes its output there.
// Otherwise each split writes f32 partials (m, l, acc[hd]); the last live
// split to arrive, found by a per-(slot, head) ticket that it resets to 0
// itself, merges them in split order: out = sum_i acc_i e^(m_i - M) /
// max(sum_i l_i e^(m_i - M), 1e-30), M = max_i m_i, reading eight
// splits' partials at a time from L2. The bits are the same from launch
// to launch. No tensor cores, no TMA.

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

template <typename QT, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const QT* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths, QT* __restrict__ out,
                        int head_dim, int embed, long long q_stride_slot,
                        long long stride_outer, long long stride_row,
                        int max_len, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // keys past the cache's extent do not exist: clamp the cursor to it
  const int length = min(max(lengths[s], 0), max_len);
  const long long col = (long long)h * head_dim;

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
      const long long row =
          r < length ? (long long)s * stride_outer + (long long)r * stride_row
                     : 0;
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
                       const int* lengths, void* out, int slots, int heads,
                       int head_dim, int embed, long long q_stride_slot,
                       long long stride_outer, long long stride_row,
                       int max_len, float scale, cudaStream_t stream) {
  decode_attention_kernel<QT, DPL><<<dim3(slots, heads), kWarps * 32, 0,
                                     stream>>>(
      (const QT*)q, (const float*)k, (const float*)v, lengths, (QT*)out,
      head_dim, embed, q_stride_slot, stride_outer, stride_row, max_len,
      scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_types(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, int slots, int heads,
                         int head_dim, int embed, long long q_stride_slot,
                         long long stride_outer, long long stride_row,
                         int max_len, float scale, cudaStream_t stream) {
#define FF_LAUNCH(D)                                                     \
  return launch_dpl<QT, D>(q, k, v, lengths, out, slots, heads, head_dim, \
                           embed, q_stride_slot, stride_outer, stride_row, \
                           max_len, scale, stream)
  if (head_dim <= 32) FF_LAUNCH(1);
  if (head_dim <= 64) FF_LAUNCH(2);
  if (head_dim <= 128) FF_LAUNCH(4);
  FF_LAUNCH(8);
#undef FF_LAUNCH
}

// ------------------------------------------------------------------ K3

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxSplitKeys = 64;
constexpr int kMaxSplitFloats = 4096;  // of K (and of V) a split stages

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// asynchronous copies into shared memory: 16 bytes (bypassing L1) or 4
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One CTA per (split, head, slot): the split's live keys [k0, k0 + n) of
// the slot, at most kMaxSplitKeys, with keys_per_split * head_dim <=
// kMaxSplitFloats. VEC: 16-byte copies (head_dim, the pool's strides and
// base multiples of 4 floats), else 4-byte ones. `part` holds (slots,
// heads, splits, head_dim + 2) f32 partials (m, l, acc); `tickets` (slots,
// heads) ints, 0 between launches.
template <typename QT, int DPL, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const QT* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ lengths,
                          const int* __restrict__ table, QT* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ tickets,
                          int head_dim, int embed, long long q_stride_slot,
                          long long stride_outer, long long stride_row,
                          int block_size, int table_width, int num_blocks,
                          int keys_per_split, float scale) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.x;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = split * keys_per_split;  // < table_width * block_size
  const int p0 = k0 / block_size;
  // The split's page-table entries (one thread a page) go out beside its
  // slot's length: a split past the cursor discards them unread.
  const int pages =
      min((k0 + keys_per_split - 1) / block_size, table_width - 1) - p0 + 1;
  const int phys =
      tid < pages ? __ldg(table + (long long)s * table_width + p0 + tid) : 0;
  // keys past the table's extent do not exist: clamp the cursor to it
  const int length = min(max(lengths[s], 0), table_width * block_size);
  const long long col = (long long)h * head_dim;
  QT* o = out + (long long)s * embed + col;
  if (k0 >= length) {
    // a split past the cursor reads nothing; split 0 of an empty slot
    // writes its zeros
    if (split == 0)
      for (int d = tid; d < head_dim; d += kSplitThreads)
        o[d] = store_as<QT>(0.f);
    return;
  }
  const int n = min(keys_per_split, length - k0);
  const int live = (length + keys_per_split - 1) / keys_per_split;

  extern __shared__ __align__(16) float sm_kv[];
  float* sk = sm_kv;                                // [n][head_dim]
  float* sv = sm_kv + keys_per_split * head_dim;    // [n][head_dim]
  __shared__ long long sm_row[kMaxSplitKeys];
  __shared__ float sm_p[kMaxSplitKeys];
  __shared__ float sm_m, sm_l;
  __shared__ int sm_last;

  // Each live page: its physical block checked against the pool (a
  // corrupt table stops the kernel, as the plain version's gather raises,
  // rather than read another block), then its rows' offsets, with no
  // per-key division.
  const int p1 = (k0 + n - 1) / block_size;
  if (tid <= p1 - p0) {
    assert(phys >= 0 && phys < num_blocks);
    const int page = p0 + tid;
    const int r0 = max(k0, page * block_size);
    const int r1 = min(k0 + n, (page + 1) * block_size);
    const long long base = (long long)phys * stride_outer + col -
                           (long long)page * block_size * stride_row;
    for (int r = r0; r < r1; ++r)
      sm_row[r - k0] = base + (long long)r * stride_row;
  }
  // this lane's dims of q, in the compute dtype
  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < head_dim ? load_f(q + s * q_stride_slot + col + d) : 0.f;
  }
  __syncthreads();

  // K's live rows, then V's, into shared memory, as two groups of
  // asynchronous copies all in flight at once: warp w takes rows w, w + 4,
  // ..., its lanes the row's pieces. Rows past the cursor are never read.
  constexpr int E = VEC ? 4 : 1;
  const int pieces = head_dim / E;
  for (int r = warp; r < n; r += kSplitWarps)
    for (int c = lane; c < pieces; c += 32)
      cp_async<4 * E>(sk + r * head_dim + c * E, k + sm_row[r] + c * E);
  cp_async_commit();
  for (int r = warp; r < n; r += kSplitWarps)
    for (int c = lane; c < pieces; c += 32)
      cp_async<4 * E>(sv + r * head_dim + c * E, v + sm_row[r] + c * E);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // logits (f32, K rounded to the compute dtype as it is read): warp w
  // takes keys w, w + 4, ..., kKeysAtOnce of them at once so that their
  // shuffle sums overlap
  constexpr int kKeysAtOnce = 4;
  for (int j0 = warp; j0 < n; j0 += kKeysAtOnce * kSplitWarps) {
    float dot[kKeysAtOnce];
#pragma unroll
    for (int u = 0; u < kKeysAtOnce; ++u) {
      const int j = min(j0 + u * kSplitWarps, n - 1);
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < head_dim) a += qv[i] * round_to<QT>(sk[j * head_dim + d]);
      }
      dot[u] = a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kKeysAtOnce; ++u)
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < kKeysAtOnce; ++u)
        if (j0 + u * kSplitWarps < n)
          sm_p[j0 + u * kSplitWarps] = dot[u] * scale;
  }
  __syncthreads();
  // the split's max m, p = exp(logit - m), l = sum p, and round(p) in place
  if (warp == 0) {
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sm_p[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sm_p[j] - m);
      l += p;
      sm_p[j] = round_to<QT>(p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      sm_m = m;
      sm_l = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V (V rounded as it is read): thread t takes dims t and t + 128
  const float m = sm_m;
  const float l = sm_l;
  float acc[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = tid + kSplitThreads * e;
    float a = 0.f;
    if (d < head_dim) {
#pragma unroll 4
      for (int j = 0; j < n; ++j)
        a += sm_p[j] * round_to<QT>(sv[j * head_dim + d]);
    }
    acc[e] = a;
  }
  if (live == 1) {  // the slot's only split: no partials, no merge
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = tid + kSplitThreads * e;
      if (d < head_dim) o[d] = store_as<QT>(acc[e] / fmaxf(l, 1e-30f));
    }
    return;
  }

  // write this split's partial; the last of the slot's live splits to
  // arrive (a ticket it resets to 0 itself) merges them all in split
  // order, so the bits do not depend on which CTA that is
  const int sh = s * heads + h;
  const int stride = head_dim + 2;
  float* all = part + (long long)sh * splits * stride;
  float* mine = all + (long long)split * stride;
  if (tid == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = tid + kSplitThreads * e;
    if (d < head_dim) mine[2 + d] = acc[e];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(tickets + sh, 1) == live - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (tid == 0) tickets[sh] = 0;
  // The partials are read from L2 (__ldcg: other SMs wrote them),
  // kMergeAtOnce splits' loads in flight at a time; every live split saw
  // at least one key, so each m_i is finite. The max is exact in any
  // order; the sums run in split order.
  constexpr int kMergeAtOnce = 8;
  float big = -CUDART_INF_F;
  for (int i0 = 0; i0 < live; i0 += kMergeAtOnce) {
    float mv[kMergeAtOnce];
#pragma unroll
    for (int u = 0; u < kMergeAtOnce; ++u)
      mv[u] = i0 + u < live ? __ldcg(all + (long long)(i0 + u) * stride)
                            : -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kMergeAtOnce; ++u) big = fmaxf(big, mv[u]);
  }
  float total = 0.f;
  float a[2] = {0.f, 0.f};
  for (int i0 = 0; i0 < live; i0 += kMergeAtOnce) {
    float wv[kMergeAtOnce], lv[kMergeAtOnce], av[2][kMergeAtOnce];
#pragma unroll
    for (int u = 0; u < kMergeAtOnce; ++u) {
      const bool ok = i0 + u < live;
      const float* pi = all + (long long)(i0 + u) * stride;
      wv[u] = ok ? __ldcg(pi) : 0.f;
      lv[u] = ok ? __ldcg(pi + 1) : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = tid + kSplitThreads * e;
        av[e][u] = ok && d < head_dim ? __ldcg(pi + 2 + d) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeAtOnce; ++u) {
      if (i0 + u >= live) break;
      const float w = expf(wv[u] - big);
      total += lv[u] * w;
#pragma unroll
      for (int e = 0; e < 2; ++e) a[e] += av[e][u] * w;
    }
  }
  const float denom = fmaxf(total, 1e-30f);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = tid + kSplitThreads * e;
    if (d < head_dim) o[d] = store_as<QT>(a[e] / denom);
  }
}

template <typename QT, bool VEC>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* lengths, const int* table, void* out,
                         float* part, int* tickets, int slots, int heads,
                         int head_dim, int embed, long long q_stride_slot,
                         long long stride_outer, long long stride_row,
                         int block_size, int table_width, int num_blocks,
                         int keys_per_split, int splits, float scale,
                         cudaStream_t stream) {
  const dim3 grid(splits, heads, slots);
  const size_t smem = 2 * (size_t)keys_per_split * head_dim * sizeof(float);
#define FF_LAUNCH(D)                                                       \
  paged_decode_split_kernel<QT, D, VEC><<<grid, kSplitThreads, smem,      \
                                          stream>>>(                       \
      (const QT*)q, (const float*)k, (const float*)v, lengths, table,      \
      (QT*)out, part, tickets, head_dim, embed, q_stride_slot,             \
      stride_outer, stride_row, block_size, table_width, num_blocks,       \
      keys_per_split, scale);                                              \
  return cudaGetLastError()
  if (head_dim <= 32) { FF_LAUNCH(1); }
  if (head_dim <= 64) { FF_LAUNCH(2); }
  if (head_dim <= 128) { FF_LAUNCH(4); }
  FF_LAUNCH(8);
#undef FF_LAUNCH
}

}  // namespace

// Plain C interfaces, bound by ctypes. Pointers are device pointers; k and
// v are f32. Each returns a cudaError_t code (0 = the launch was
// accepted), or -1 for a q dtype, head size or geometry it does not take.

// K2: the contiguous cache (slots, max_len, embed) through its strides.
extern "C" int ff_decode_attention(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* out, int slots, int heads,
                                   int head_dim, int embed,
                                   long long q_stride_slot,
                                   long long stride_outer,
                                   long long stride_row, int max_len,
                                   float scale, int q_dtype, void* stream) {
  if (head_dim < 1 || head_dim > 256 || slots < 1 || heads < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_TYPES(QT)                                                         \
  return (int)launch_types<QT>(q, k, v, lengths, out, slots, heads,         \
                               head_dim, embed, q_stride_slot, stride_outer, \
                               stride_row, max_len, scale, st)
  if (q_dtype == kF32) FF_TYPES(float);
  if (q_dtype == kBF16) FF_TYPES(__nv_bfloat16);
#undef FF_TYPES
  return -1;
}

// K3: the pool (num_blocks, block_size, embed) through the page table
// (slots, table_width), split into `splits` runs of keys_per_split keys
// (the wrapper's paged_decode_geometry); part and tickets as the kernel
// above; vec: 16-byte copies.
extern "C" int ff_paged_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* table, void* out, float* part, int* tickets, int slots,
    int heads, int head_dim, int embed, long long q_stride_slot,
    long long stride_outer, long long stride_row, int block_size,
    int table_width, int num_blocks, int keys_per_split, int splits,
    float scale, int q_dtype, int vec, void* stream) {
  if (head_dim < 1 || head_dim > 256 || slots < 1 || slots > 65535 ||
      heads < 1 || heads > 65535 || block_size < 1 || num_blocks < 1 ||
      table_width < 1 || table_width > 12288 ||
      (long long)table_width * block_size > 0x7fffffffLL ||
      keys_per_split < 1 ||
      keys_per_split > kMaxSplitKeys ||
      keys_per_split * head_dim > kMaxSplitFloats || splits < 1 ||
      (long long)splits * keys_per_split <
          (long long)table_width * block_size ||
      (vec && head_dim % 4 != 0))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_TYPES(QT, VEC)                                                   \
  return (int)launch_split<QT, VEC>(                                        \
      q, k, v, lengths, table, out, part, tickets, slots, heads, head_dim, \
      embed, q_stride_slot, stride_outer, stride_row, block_size,          \
      table_width, num_blocks, keys_per_split, splits, scale, st)
  if (q_dtype == kF32) {
    if (vec) FF_TYPES(float, true);
    FF_TYPES(float, false);
  }
  if (q_dtype == kBF16) {
    if (vec) FF_TYPES(__nv_bfloat16, true);
    FF_TYPES(__nv_bfloat16, false);
  }
#undef FF_TYPES
  return -1;
}
