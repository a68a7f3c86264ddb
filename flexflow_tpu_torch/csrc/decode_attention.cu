// Single-query decode attention over a KV cache: contiguous (K2) or paged
// (K3), one split-K kernel for both.
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
// (the kernel's runs of keys differ from the TPU kernels' blocks, so p is
// rounded against another m: a bf16 step at most), round() = rounding to
// the compute dtype of q, and the output cast once to q's dtype. Keys past
// the cursor are never read: in the TPU kernels they are masked to -1e30
// (exp -> exactly 0) and their V rows zeroed before P.V, so skipping them
// gives the same sums and a stale NaN in a dead row cannot reach the
// output. A slot with length 0 reads nothing and writes 0.
//
// The KV state rests in f32 while compute runs in bf16. The JAX ops cast
// the whole cache or pool to bf16 every layer and step; this kernel reads
// the f32 rows and rounds each element to the compute dtype as it reads
// it, which gives the same numbers with no cache-sized copy.
//
// Bound on the H100: bytes. Each live key costs 2*hd*4 bytes of f32 K and V
// per head and 2*hd flops per matrix product, about 0.5 flop per byte, far
// below the ~295 flops/byte where the tensor cores would become the limit
// (lm-base serving, 8 slots of 16 heads of 64, phase 8's lengths: 1245 live
// keys, 10.2 MB, 3.05 us).
//
// Design (split-K): one CTA of 128 threads per (split, head, slot), a
// split being a fixed run of keys_per_split logical keys (32 at head_dim
// 64; on the paged layout whole pages where a page is no wider than the
// split), so a long slot spreads over many SMs instead of setting the
// time alone. The grid comes from shapes only (the wrapper's
// decode_split_geometry, paged_decode_geometry): the host never reads the
// lengths, and a split past its slot's cursor exits after one load. The
// two layouts share one body (decode_split) and differ only in a
// compile-time address map from (slot, key) to a row: contiguous, slot *
// stride0 + key * stride1 (no table); paged, the page table; and in the
// launch bounds of their two kernels (kContiguousCtasPerSm). A paged
// split reads each of its pages' physical block once, by one thread,
// while its slot's length is on its way (one memory round trip for both),
// checks the live ones against the pool (a device assert), and lays out
// their rows' offsets with no per-key division.
// Then every live K row and V row of the split goes to shared memory as
// asynchronous copies (16-byte cp.async where head_dim, the cache's
// strides and bases allow, 4-byte otherwise), all in flight at once in two
// groups (K, then V). The logits (a warp per key, four keys' shuffle sums
// interleaved) wait only for K; warp 0 takes the split's max m, p =
// exp(logit - m), l and round(p); P.V (a thread per dim) waits for V. A
// slot with one live split writes its output there. Otherwise each split
// writes f32 partials (m, l, acc[hd]); the last live split to arrive,
// found by a per-(slot, head) ticket that it resets to 0 itself, merges
// them in split order: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i
// e^(m_i - M), 1e-30), M = max_i m_i, reading eight splits' partials at a
// time from L2. The bits are the same from launch to launch. No tensor
// cores, no TMA.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxSplitKeys = 64;
constexpr int kMaxSplitFloats = 4096;  // of K (and of V) a split stages
// CTAs an SM the contiguous layout's registers must allow (at most 102 a
// thread): unbounded, its body took 112 at lm-base's head_dim 64 (4 CTAs
// an SM) and ran slower on the H100. The paged layout's took 96 (5 CTAs
// an SM) and ran slower bounded, so it is not.
constexpr int kContiguousCtasPerSm = 5;

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

// The arguments of one launch, either layout. The cache's rows are f32;
// the paged fields are read only by the paged instantiation.
struct SplitArgs {
  const void* q;
  const float* k;
  const float* v;
  const int* lengths;
  const int* table;  // paged: (slots, table_width) physical blocks
  void* out;
  float* part;   // (slots, heads, splits, head_dim + 2) f32 (m, l, acc)
  int* tickets;  // (slots, heads), 0 between launches
  int head_dim;
  int embed;
  long long q_stride_slot;
  long long stride_outer;  // contiguous: a slot; paged: a block
  long long stride_row;    // a key
  int extent;  // keys a slot can hold: S, or table_width * block_size
  int block_size, table_width, num_blocks;  // paged only
  int keys_per_split;
  float scale;
};

// One CTA per (split, head, slot): the split's live keys [k0, k0 + n) of
// the slot, at most kMaxSplitKeys, with keys_per_split * head_dim <=
// kMaxSplitFloats. VEC: 16-byte copies (head_dim, the cache's strides and
// bases multiples of 4 floats), else 4-byte ones. PAGED: key r of slot s
// is row r % block_size of block table[s][r / block_size]; else row r of
// slot s.
template <typename QT, int DPL, bool VEC, bool PAGED>
__device__ __forceinline__ void decode_split(const SplitArgs& a) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.x;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head_dim = a.head_dim;
  const int keys_per_split = a.keys_per_split;
  const long long stride_row = a.stride_row;
  const QT* q = (const QT*)a.q;
  const int k0 = split * keys_per_split;  // < extent
  // The split's page-table entries (one thread a page) go out beside its
  // slot's length: a split past the cursor discards them unread.
  int p0 = 0, phys = 0;
  if constexpr (PAGED) {
    p0 = k0 / a.block_size;
    const int pages = min((k0 + keys_per_split - 1) / a.block_size,
                          a.table_width - 1) - p0 + 1;
    if (tid < pages)
      phys = __ldg(a.table + (long long)s * a.table_width + p0 + tid);
  }
  // keys past the cache's extent do not exist: clamp the cursor to it
  const int length = min(max(a.lengths[s], 0), a.extent);
  const long long col = (long long)h * head_dim;
  QT* o = (QT*)a.out + (long long)s * a.embed + col;
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
  __shared__ long long sm_row[PAGED ? kMaxSplitKeys : 1];
  __shared__ float sm_p[kMaxSplitKeys];
  __shared__ float sm_m, sm_l;
  __shared__ int sm_last;

  // The split's rows: contiguous, at a fixed stride from the split's first
  // key; paged, laid out per live page after its physical block is checked
  // against the pool (a corrupt table stops the kernel, as the plain
  // version's gather raises, rather than read another block), with no
  // per-key division.
  const long long first =
      (long long)s * a.stride_outer + (long long)k0 * stride_row + col;
  if constexpr (PAGED) {
    const int bs = a.block_size;
    const int p1 = (k0 + n - 1) / bs;
    if (tid <= p1 - p0) {
      assert(phys >= 0 && phys < a.num_blocks);
      const int page = p0 + tid;
      const int r0 = max(k0, page * bs);
      const int r1 = min(k0 + n, (page + 1) * bs);
      const long long base = (long long)phys * a.stride_outer + col -
                             (long long)page * bs * stride_row;
      for (int r = r0; r < r1; ++r)
        sm_row[r - k0] = base + (long long)r * stride_row;
    }
  }
  auto row_at = [&](int r) -> long long {
    if constexpr (PAGED) return sm_row[r];
    return first + (long long)r * stride_row;
  };
  // this lane's dims of q, in the compute dtype
  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < head_dim ? load_f(q + s * a.q_stride_slot + col + d) : 0.f;
  }
  if constexpr (PAGED) __syncthreads();

  // K's live rows, then V's, into shared memory, as two groups of
  // asynchronous copies all in flight at once: warp w takes rows w, w + 4,
  // ..., its lanes the row's pieces. Rows past the cursor are never read.
  constexpr int E = VEC ? 4 : 1;
  const int pieces = head_dim / E;
  for (int r = warp; r < n; r += kSplitWarps)
    for (int c = lane; c < pieces; c += 32)
      cp_async<4 * E>(sk + r * head_dim + c * E, a.k + row_at(r) + c * E);
  cp_async_commit();
  for (int r = warp; r < n; r += kSplitWarps)
    for (int c = lane; c < pieces; c += 32)
      cp_async<4 * E>(sv + r * head_dim + c * E, a.v + row_at(r) + c * E);
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
      float qk = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < head_dim) qk += qv[i] * round_to<QT>(sk[j * head_dim + d]);
      }
      dot[u] = qk;
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
          sm_p[j0 + u * kSplitWarps] = dot[u] * a.scale;
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
    float pv = 0.f;
    if (d < head_dim) {
#pragma unroll 4
      for (int j = 0; j < n; ++j)
        pv += sm_p[j] * round_to<QT>(sv[j * head_dim + d]);
    }
    acc[e] = pv;
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
  float* all = a.part + (long long)sh * splits * stride;
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
  if (tid == 0) sm_last = atomicAdd(a.tickets + sh, 1) == live - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (tid == 0) a.tickets[sh] = 0;
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
  float sum[2] = {0.f, 0.f};
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
      for (int e = 0; e < 2; ++e) sum[e] += av[e][u] * w;
    }
  }
  const float denom = fmaxf(total, 1e-30f);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = tid + kSplitThreads * e;
    if (d < head_dim) o[d] = store_as<QT>(sum[e] / denom);
  }
}

// The body's two kernels: K2 over the contiguous cache, K3 over the pool
template <typename QT, int DPL, bool VEC>
__global__ void __launch_bounds__(kSplitThreads, kContiguousCtasPerSm)
decode_split_kernel(const SplitArgs a) {
  decode_split<QT, DPL, VEC, false>(a);
}

template <typename QT, int DPL, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const SplitArgs a) {
  decode_split<QT, DPL, VEC, true>(a);
}

template <typename QT, bool VEC, bool PAGED>
cudaError_t launch_split(const SplitArgs& a, int slots, int heads,
                         int splits, cudaStream_t stream) {
  const dim3 grid(splits, heads, slots);
  const size_t smem = 2 * (size_t)a.keys_per_split * a.head_dim *
                      sizeof(float);
#define FF_LAUNCH(D)                                                       \
  if constexpr (PAGED)                                                     \
    paged_decode_split_kernel<QT, D, VEC><<<grid, kSplitThreads, smem,    \
                                            stream>>>(a);                  \
  else                                                                     \
    decode_split_kernel<QT, D, VEC><<<grid, kSplitThreads, smem,          \
                                      stream>>>(a);                        \
  return cudaGetLastError()
  if (a.head_dim <= 32) { FF_LAUNCH(1); }
  if (a.head_dim <= 64) { FF_LAUNCH(2); }
  if (a.head_dim <= 128) { FF_LAUNCH(4); }
  FF_LAUNCH(8);
#undef FF_LAUNCH
}

// What both entries refuse: a head, a split or a grid the kernel was not
// built for, or fewer splits than cover the extent.
bool split_args_ok(const SplitArgs& a, int slots, int heads, int splits,
                   int vec) {
  const long long covered = (long long)splits * a.keys_per_split;
  return a.head_dim >= 1 && a.head_dim <= 256 && slots >= 1 &&
         slots <= 65535 && heads >= 1 && heads <= 65535 && a.extent >= 1 &&
         a.keys_per_split >= 1 && a.keys_per_split <= kMaxSplitKeys &&
         a.keys_per_split * a.head_dim <= kMaxSplitFloats && splits >= 1 &&
         covered >= a.extent && covered <= 0x7fffffffLL &&
         !(vec && a.head_dim % 4 != 0);
}

template <bool PAGED>
int launch_types(const SplitArgs& a, int slots, int heads, int splits,
                 int q_dtype, int vec, cudaStream_t st) {
#define FF_TYPES(QT, VEC) \
  return (int)launch_split<QT, VEC, PAGED>(a, slots, heads, splits, st)
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

}  // namespace

// Plain C interfaces, bound by ctypes. Pointers are device pointers; k and
// v are f32. Each launches the split kernel over `splits` runs of
// keys_per_split keys (the wrapper's geometry), with `part` and `tickets`
// as SplitArgs says and vec for 16-byte copies, and returns a cudaError_t
// code (0 = the launch was accepted), or -1 for a q dtype, head size or
// geometry it does not take.

// K2: the contiguous cache (slots, max_len, embed) through its strides.
extern "C" int ff_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part, int* tickets, int slots, int heads,
    int head_dim, int embed, long long q_stride_slot, long long stride_outer,
    long long stride_row, int max_len, int keys_per_split, int splits,
    float scale, int q_dtype, int vec, void* stream) {
  const SplitArgs a{q, (const float*)k, (const float*)v, lengths, nullptr,
                    out, part, tickets, head_dim, embed, q_stride_slot,
                    stride_outer, stride_row, max_len, 1, 1, 1,
                    keys_per_split, scale};
  if (!split_args_ok(a, slots, heads, splits, vec)) return -1;
  return launch_types<false>(a, slots, heads, splits, q_dtype, vec,
                             (cudaStream_t)stream);
}

// K3: the pool (num_blocks, block_size, embed) through the page table
// (slots, table_width).
extern "C" int ff_paged_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* table, void* out, float* part, int* tickets, int slots,
    int heads, int head_dim, int embed, long long q_stride_slot,
    long long stride_outer, long long stride_row, int block_size,
    int table_width, int num_blocks, int keys_per_split, int splits,
    float scale, int q_dtype, int vec, void* stream) {
  if (block_size < 1 || num_blocks < 1 || table_width < 1 ||
      table_width > 12288 ||
      (long long)table_width * block_size > 0x7fffffffLL)
    return -1;
  const SplitArgs a{q, (const float*)k, (const float*)v, lengths, table,
                    out, part, tickets, head_dim, embed, q_stride_slot,
                    stride_outer, stride_row, table_width * block_size,
                    block_size, table_width, num_blocks, keys_per_split,
                    scale};
  if (!split_args_ok(a, slots, heads, splits, vec)) return -1;
  return launch_types<true>(a, slots, heads, splits, q_dtype, vec,
                            (cudaStream_t)stream);
}
