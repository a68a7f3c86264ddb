// LayerNorm over the last axis: the forward (K1), y, and the backward
// (K4), dx, dscale and dbias.
//
// Replaces the TPU kernels flexflow_tpu/kernels/layer_norm.py:_fwd_kernel
// (48), reached through fused_layer_norm_or_none (140) -> _fused_ln (99)
// -> _call_fwd (80; pallas_call at 84), and _bwd_kernel (59), the backward
// of the _fused_ln custom VJP (_fused_ln_bwd, 108; pallas_call at 113).
//
// What they compute, per row of x (n, d), in f32: mean, the variance of
// the centred row (not E[x^2] - mean^2), rstd = rsqrt(var + eps), xhat =
// (x - mean) rstd. K1: y = xhat scale + bias, cast once to x's dtype; x
// is f32, bf16 or f16, scale and bias each any of the three, read as f32.
// K4: dyh = dy scale, and dx = rstd (dyh - mean(dyh) - xhat mean(dyh
// xhat)) cast once to x's dtype; over rows, dscale = sum dy xhat and dbias
// = sum dy, both f32. x and dy are f32, bf16 or f16 (one type); scale is
// any of the three, read as f32.
//
// Bound on the H100: bytes. K1 reads x once and writes y once (2 n d
// elements; lm-base's (4096, 1024) bf16: 16.8 MB, 5.0 us at 3.35 TB/s;
// lm-xxl-fsdp's (8192, 4096): 134 MB, 40.1 us), at ~8 f32 operations an
// element. K4 reads x and dy once and writes dx once (3 n d elements;
// 25.2 MB, 7.5 us; 201 MB, 60.1 us), at ~16. Both far below the
// tensor-core line.
//
// Design. Rows live in registers and are reduced inside the warp:
//  - "rows" kernels, d <= 32 EPT (EPT elements a thread; K4: 32 in
//    bf16/f16, 16 in f32, so d <= 1024 / 512): one warp takes a row,
//    16-byte loads (VEC; else element loads, for widths or strides that
//    are no multiple of 16 bytes), statistics by __shfl_xor_sync with no
//    block barrier. d <= 128 EPT (4096 / 2048): four warps take a row,
//    one shared-memory exchange per reduction (two buffers, one barrier).
//    K1 takes the fewest elements a thread that cover the row with four
//    warps, in whole 16-byte vectors (8, 16 or 32 bf16; 4, 8 or 16 f32):
//    at lm-base's 1024 four warps of 8, which hold 4x more rows in flight
//    an SM than one warp of 32 (fewer registers a thread).
//  - "wide" kernels, wider rows: four warps a row (K1 also one, for
//    launch-shape sweeps), passes of 32 warps EPT columns (mean, centred
//    variance, then y; K4: the two dot products, then dx), the re-reads
//    served from L2.
//  - A persistent grid: SMs x resident CTAs of 128 threads (the wrapper
//    takes the count from `ff_layer_norm_fwd_occupancy` /
//    `ff_layer_norm_bwd_occupancy` and the SM count, read once), each CTA
//    striding over rows. A warp issues the next row's loads into
//    registers before this row's math, so each SM keeps a few rows in
//    flight.
//  - K1: a thread owns the same columns on every row, so it loads their
//    scale and bias once, into registers (16-byte vectors of their own
//    dtype where VEC), after its first row's x.
//  - K4's dscale and dbias: a thread's columns are the same on every row,
//    so it keeps their sums in registers across its rows. The CTA adds its
//    row groups in order into one partial row (n_ctas, 2, d) f32 (the
//    wide kernel adds into it in place, row by row). A second small
//    kernel of this file, in the same entry, sums the partial rows in
//    CTA order (32 warps a 32-column slice, each a fixed subset of rows,
//    then the warps in order). No float atomics: the bits are the same
//    from launch to launch.
// The TPU kernels' Mosaic gates (d % 128, 8-aligned row blocks) and K4's
// 8-sublane broadcast of the partials are TPU tiling, not semantics.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSumWarps = 32;  // the column-sum kernel: 32 warps, 32 columns

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

struct LnBwd {
  const void* x;
  const void* dy;
  const void* scale;
  void* dx;
  float* part;  // (gridDim.x, 2, d): this CTA's dscale and dbias rows
  long long n;
  long long x_stride;
  long long dy_stride;
  long long dx_stride;
  int d;
  int scale_code;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float load_scale(const void* s, int code,
                                            int i) {
  if (code == kBF16) return __bfloat162float(((const __nv_bfloat16*)s)[i]);
  if (code == kF16) return __half2float(((const __half*)s)[i]);
  return ((const float*)s)[i];
}

// The EPT elements a thread holds of one NT-thread pass over a row: with
// 16-byte vectors (V elements each), element i sits at column
// off + ((i / V) * NT + t) * V + i % V; without, at off + i * NT + t.
template <typename T, int NT, int EPT, bool VEC>
struct Cols {
  static constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  static constexpr int kNT = NT;
  static __device__ __forceinline__ int col(int off, int t, int i) {
    return off + ((i / V) * NT + t) * V + i % V;
  }
  static __device__ __forceinline__ void load(T (&r)[EPT], const T* row,
                                              int off, int t, int d) {
#pragma unroll
    for (int j = 0; j < EPT / V; ++j) {
      const int c = col(off, t, j * V);
      if (VEC) {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (c < d) w = __ldg(reinterpret_cast<const uint4*>(row + c));
        *reinterpret_cast<uint4*>(&r[j * V]) = w;
      } else {
        r[j] = c < d ? row[c] : from_f<T>(0.f);
      }
    }
  }
  // vector j of a pass (V elements: its columns col(off, t, j * V) on)
  static __device__ __forceinline__ void store(T* row, const float (&v)[V],
                                               int off, int t, int d, int j) {
    const int c = col(off, t, j * V);
    if (c >= d) return;
    if (VEC) {
      __align__(16) T w[V];
#pragma unroll
      for (int k = 0; k < V; ++k) w[k] = from_f<T>(v[k]);
      *reinterpret_cast<uint4*>(row + c) = *reinterpret_cast<uint4*>(w);
    } else {
      row[c] = from_f<T>(v[0]);
    }
  }
};

// The sums (a, b) over the WPR warps of a row: shuffles within each warp,
// then, for WPR > 1 (the whole CTA is one row group), one exchange through
// shared memory. Two buffers taken in turn (`turn`) need one barrier: a
// warp writes a buffer again only after the barrier of the exchange
// between, which every warp reaches after reading it.
template <int WPR>
__device__ __forceinline__ float2 row_sum(float a, float b,
                                          float2 (*sm)[kWarps], int& turn) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (WPR == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  float2* buf = sm[turn];
  turn ^= 1;
  if ((threadIdx.x & 31) == 0) buf[warp] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < WPR; ++w) {
    r.x += buf[w].x;
    r.y += buf[w].y;
  }
  return r;
}

// A row's (mean, rstd) in f32 from the EPT elements a thread holds of it
// (masked columns hold 0): the mean first, then the mean of the centred
// row's squares, never E[x^2] - mean^2
template <typename C, int WPR, int EPT, typename T>
__device__ __forceinline__ float2 row_stats(const T (&xr)[EPT], int t, int d,
                                            float eps,
                                            float2 (*sm_red)[kWarps],
                                            int& turn) {
  const float fd = (float)d;
  float sx = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) sx += to_f(xr[i]);  // masked columns: 0
  const float mean = row_sum<WPR>(sx, 0.f, sm_red, turn).x / fd;
  float sv = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const float c = to_f(xr[i]) - mean;
    if (C::col(0, t, i) < d) sv += c * c;
  }
  return make_float2(
      mean, rsqrtf(row_sum<WPR>(sv, 0.f, sm_red, turn).x / fd + eps));
}

// scale as f32 into shared memory in the rows kernel's per-thread order
// (element i of thread t at [i * NT + t]): every load issued before the
// first store, so the CTA's prologue costs one memory round trip
template <typename C, int W, typename S>
__device__ __forceinline__ void fill_scale(float* sm, const S* scale,
                                           int d) {
  constexpr int NT = C::kNT;
  constexpr int PER = W / kThreads;
  float v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int k = threadIdx.x + u * kThreads;
    const int c = C::col(0, k % NT, k / NT);
    v[u] = c < d ? to_f(scale[c]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) sm[threadIdx.x + u * kThreads] = v[u];
}

// One row's math, its x and dy in registers: the statistics in f32, dx
// stored a vector at a time, dy xhat and dy added into the thread's
// column sums
template <typename C, int WPR, int EPT, typename T>
__device__ __forceinline__ void row_math(const T (&xr)[EPT],
                                         const T (&dr)[EPT], T* dxrow,
                                         const float* sm_scale,
                                         float (&acc_s)[EPT],
                                         float (&acc_b)[EPT], int t, int d,
                                         float eps, float2 (*sm_red)[kWarps],
                                         int& turn) {
  constexpr int NT = C::kNT;
  const float fd = (float)d;
  const float2 st = row_stats<C, WPR>(xr, t, d, eps, sm_red, turn);
  const float mean = st.x, rstd = st.y;
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    // masked columns: dy = 0, scale = 0, so they add nothing
    const float dyh = to_f(dr[i]) * sm_scale[i * NT + t];
    a1 += dyh * ((to_f(xr[i]) - mean) * rstd);
    a2 += dyh;
  }
  const float2 m = row_sum<WPR>(a1, a2, sm_red, turn);
  const float m1 = m.x / fd, m2 = m.y / fd;
#pragma unroll
  for (int j = 0; j < EPT / C::V; ++j) {
    float out[C::V];
#pragma unroll
    for (int k = 0; k < C::V; ++k) {
      const int i = j * C::V + k;
      const float xh = (to_f(xr[i]) - mean) * rstd;
      const float dyf = to_f(dr[i]);
      const float dyh = dyf * sm_scale[i * NT + t];
      out[k] = rstd * (dyh - m2 - xh * m1);
      acc_s[i] += dyf * xh;
      acc_b[i] += dyf;
    }
    C::store(dxrow, out, 0, t, d, j);
  }
}

// d <= 32 * WPR * EPT: a row in registers, WPR warps a row, kWarps / WPR
// rows in flight a CTA, the next row's loads issued before this row's math
template <typename T, int WPR, int EPT, bool VEC>
__global__ void __launch_bounds__(kThreads) ln_bwd_rows(LnBwd p) {
  constexpr int NT = 32 * WPR;
  constexpr int G = kWarps / WPR;
  constexpr int W = NT * EPT;
  using C = Cols<T, NT, EPT, VEC>;
  __shared__ float sm_scale[W];
  __shared__ float2 sm_red[2][kWarps];
  __shared__ float sm_acc[G > 1 ? G : 1][2][G > 1 ? W : 1];
  const int warp = threadIdx.x >> 5;
  const int g = warp / WPR;
  const int t = threadIdx.x % NT;
  const int d = p.d;
  const T* x = (const T*)p.x;
  const T* dy = (const T*)p.dy;
  T* dx = (T*)p.dx;
  const long long step = (long long)gridDim.x * G;
  long long row = (long long)blockIdx.x * G + g;
  // the first row's loads go out first, before the scale's
  __align__(16) T xr[EPT];
  __align__(16) T dr[EPT];
  if (row < p.n) {
    C::load(xr, x + row * p.x_stride, 0, t, d);
    C::load(dr, dy + row * p.dy_stride, 0, t, d);
  }
  // scale, laid out by thread: element i of thread t at [i * NT + t], so
  // a warp's reads of it hit 32 banks
  if (p.scale_code == kBF16)
    fill_scale<C, W>(sm_scale, (const __nv_bfloat16*)p.scale, d);
  else if (p.scale_code == kF16)
    fill_scale<C, W>(sm_scale, (const __half*)p.scale, d);
  else
    fill_scale<C, W>(sm_scale, (const float*)p.scale, d);
  __syncthreads();

  float acc_s[EPT], acc_b[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc_s[i] = acc_b[i] = 0.f;
  int turn = 0;
  for (; row < p.n; row += step) {
    __align__(16) T xn[EPT];
    __align__(16) T dn[EPT];
    if (row + step < p.n) {
      C::load(xn, x + (row + step) * p.x_stride, 0, t, d);
      C::load(dn, dy + (row + step) * p.dy_stride, 0, t, d);
    }
    row_math<C, WPR>(xr, dr, dx + row * p.dx_stride, sm_scale, acc_s, acc_b,
                     t, d, p.eps, sm_red, turn);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      xr[i] = xn[i];
      dr[i] = dn[i];
    }
  }

  // the CTA's partial row: its row groups' sums, in group order
  float* part = p.part + (size_t)blockIdx.x * 2 * d;
  if (G == 1) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int c = C::col(0, t, i);
      if (c < d) {
        part[c] = acc_s[i];
        part[d + c] = acc_b[i];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int c = C::col(0, t, i);
    sm_acc[g][0][c] = acc_s[i];
    sm_acc[g][1][c] = acc_b[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      a += sm_acc[k][0][c];
      b += sm_acc[k][1][c];
    }
    part[c] = a;
    part[d + c] = b;
  }
}

// d > 128 EPT: four warps a row, passes of 128 EPT columns; the CTA's
// partial row is updated in place, row by row (only this CTA touches it,
// each column always by the same thread)
template <typename T, int EPT, bool VEC>
__global__ void __launch_bounds__(kThreads) ln_bwd_wide(LnBwd p) {
  constexpr int NT = kThreads;
  constexpr int W = NT * EPT;
  using C = Cols<T, NT, EPT, VEC>;
  __shared__ float2 sm_red[2][kWarps];
  const int t = threadIdx.x;
  const int d = p.d;
  const float fd = (float)d;
  float* part = p.part + (size_t)blockIdx.x * 2 * d;
  int turn = 0;
  bool first = true;
  for (long long row = blockIdx.x; row < p.n; row += gridDim.x) {
    const T* xrow = (const T*)p.x + row * p.x_stride;
    const T* dyrow = (const T*)p.dy + row * p.dy_stride;
    T* dxrow = (T*)p.dx + row * p.dx_stride;
    __align__(16) T xr[EPT];
    __align__(16) T dr[EPT];
    float sx = 0.f;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
#pragma unroll
      for (int i = 0; i < EPT; ++i) sx += to_f(xr[i]);
    }
    const float mean = row_sum<4>(sx, 0.f, sm_red, turn).x / fd;
    float sv = 0.f;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const float c = to_f(xr[i]) - mean;
        if (C::col(off, t, i) < d) sv += c * c;
      }
    }
    const float rstd =
        rsqrtf(row_sum<4>(sv, 0.f, sm_red, turn).x / fd + p.eps);
    float a1 = 0.f, a2 = 0.f;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
      C::load(dr, dyrow, off, t, d);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int c = C::col(off, t, i);
        const float s = c < d ? load_scale(p.scale, p.scale_code, c) : 0.f;
        const float dyh = to_f(dr[i]) * s;
        a1 += dyh * ((to_f(xr[i]) - mean) * rstd);
        a2 += dyh;
      }
    }
    const float2 m = row_sum<4>(a1, a2, sm_red, turn);
    const float m1 = m.x / fd, m2 = m.y / fd;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
      C::load(dr, dyrow, off, t, d);
#pragma unroll
      for (int j = 0; j < EPT / C::V; ++j) {
        float out[C::V];
#pragma unroll
        for (int k = 0; k < C::V; ++k) {
          const int i = j * C::V + k;
          const int c = C::col(off, t, i);
          const float s =
              c < d ? load_scale(p.scale, p.scale_code, c) : 0.f;
          const float xh = (to_f(xr[i]) - mean) * rstd;
          const float dyf = to_f(dr[i]);
          out[k] = rstd * (dyf * s - m2 - xh * m1);
          if (c < d) {
            part[c] = (first ? 0.f : part[c]) + dyf * xh;
            part[d + c] = (first ? 0.f : part[d + c]) + dyf;
          }
        }
        C::store(dxrow, out, off, t, d, j);
      }
    }
    first = false;
  }
}

// ds[c] and db[c]: the partial rows summed in CTA order. A block of
// kSumWarps warps takes 32 columns; warp w sums the rows w, w + kSumWarps,
// ... in order, then warp 0 adds the warps in order.
__global__ void __launch_bounds__(kSumWarps * 32)
ln_bwd_colsum(const float* __restrict__ part, int parts, int d,
              float* __restrict__ ds, float* __restrict__ db) {
  __shared__ float sm[2][kSumWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int r = warp; r < parts; r += kSumWarps) {
      a += part[(size_t)r * 2 * d + c];
      b += part[(size_t)r * 2 * d + d + c];
    }
  }
  sm[0][warp][lane] = a;
  sm[1][warp][lane] = b;
  __syncthreads();
  if (warp == 0 && c < d) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) {
      x += sm[0][w][lane];
      y += sm[1][w][lane];
    }
    ds[c] = x;
    db[c] = y;
  }
}

// ------------------------------------------------------------------ K1

struct LnFwd {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  long long n;
  long long x_stride;
  long long y_stride;
  int d;
  int scale_code;
  int bias_code;
  float eps;
};

// The EPT columns a thread owns (the rows kernel's), as f32 (0 past d),
// from an array of S: with VEC, a vector of x's V columns at a time (V
// elements of S: 8, 16 or 32 bytes, one or two loads; the array 16-byte
// aligned), else an element at a time
template <typename C, int EPT, bool VEC, typename S>
__device__ __forceinline__ void load_cols(float (&r)[EPT], const S* src,
                                          int t, int d) {
  constexpr int V = C::V;
  constexpr int B = V * (int)sizeof(S);
#pragma unroll
  for (int j = 0; j < EPT / V; ++j) {
    const int c = C::col(0, t, j * V);
    if (VEC) {
      __align__(16) S w[V];
      if (c < d) {
        if constexpr (B % 16 == 0) {
#pragma unroll
          for (int q = 0; q < B / 16; ++q)
            reinterpret_cast<uint4*>(w)[q] =
                __ldg(reinterpret_cast<const uint4*>(src + c) + q);
        } else {
          *reinterpret_cast<uint2*>(w) =
              __ldg(reinterpret_cast<const uint2*>(src + c));
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) r[j * V + k] = c < d ? to_f(w[k]) : 0.f;
    } else {
      r[j] = c < d ? to_f(src[c]) : 0.f;
    }
  }
}

template <typename C, int EPT, bool VEC>
__device__ __forceinline__ void load_cols(float (&r)[EPT], const void* src,
                                          int code, int t, int d) {
  if (code == kBF16)
    load_cols<C, EPT, VEC>(r, (const __nv_bfloat16*)src, t, d);
  else if (code == kF16)
    load_cols<C, EPT, VEC>(r, (const __half*)src, t, d);
  else
    load_cols<C, EPT, VEC>(r, (const float*)src, t, d);
}

// d <= 32 * WPR * EPT: a row in registers, WPR warps a row, kWarps / WPR
// rows in flight a CTA. A thread owns the same columns on every row, so
// scale and bias stay in its registers, loaded once; the next row's x is
// issued before this row's math.
template <typename T, int WPR, int EPT, bool VEC>
__global__ void __launch_bounds__(kThreads) ln_fwd_rows(LnFwd p) {
  constexpr int NT = 32 * WPR;
  constexpr int G = kWarps / WPR;
  using C = Cols<T, NT, EPT, VEC>;
  __shared__ float2 sm_red[2][kWarps];
  const int g = (threadIdx.x >> 5) / WPR;
  const int t = threadIdx.x % NT;
  const int d = p.d;
  const T* x = (const T*)p.x;
  T* y = (T*)p.y;
  const long long step = (long long)gridDim.x * G;
  long long row = (long long)blockIdx.x * G + g;
  // the first row's loads go out first, then the scale's and the bias's
  __align__(16) T xr[EPT];
  if (row < p.n) C::load(xr, x + row * p.x_stride, 0, t, d);
  float sc[EPT], bi[EPT];
  load_cols<C, EPT, VEC>(sc, p.scale, p.scale_code, t, d);
  load_cols<C, EPT, VEC>(bi, p.bias, p.bias_code, t, d);
  int turn = 0;
  for (; row < p.n; row += step) {
    __align__(16) T xn[EPT];
    if (row + step < p.n) C::load(xn, x + (row + step) * p.x_stride, 0, t, d);
    const float2 st = row_stats<C, WPR>(xr, t, d, p.eps, sm_red, turn);
    T* yrow = y + row * p.y_stride;
#pragma unroll
    for (int j = 0; j < EPT / C::V; ++j) {
      float out[C::V];
#pragma unroll
      for (int k = 0; k < C::V; ++k) {
        const int i = j * C::V + k;
        out[k] = (to_f(xr[i]) - st.x) * st.y * sc[i] + bi[i];
      }
      C::store(yrow, out, 0, t, d, j);
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i) xr[i] = xn[i];
  }
}

// d > 32 * WPR * EPT: WPR warps a row, passes of 32 WPR EPT columns (mean,
// centred variance, then y), the re-reads served from L2
template <typename T, int WPR, int EPT, bool VEC>
__global__ void __launch_bounds__(kThreads) ln_fwd_wide(LnFwd p) {
  constexpr int NT = 32 * WPR;
  constexpr int G = kWarps / WPR;
  constexpr int W = NT * EPT;
  using C = Cols<T, NT, EPT, VEC>;
  __shared__ float2 sm_red[2][kWarps];
  const int g = (threadIdx.x >> 5) / WPR;
  const int t = threadIdx.x % NT;
  const int d = p.d;
  const float fd = (float)d;
  int turn = 0;
  for (long long row = (long long)blockIdx.x * G + g; row < p.n;
       row += (long long)gridDim.x * G) {
    const T* xrow = (const T*)p.x + row * p.x_stride;
    T* yrow = (T*)p.y + row * p.y_stride;
    __align__(16) T xr[EPT];
    float sx = 0.f;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
#pragma unroll
      for (int i = 0; i < EPT; ++i) sx += to_f(xr[i]);
    }
    const float mean = row_sum<WPR>(sx, 0.f, sm_red, turn).x / fd;
    float sv = 0.f;
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const float c = to_f(xr[i]) - mean;
        if (C::col(off, t, i) < d) sv += c * c;
      }
    }
    const float rstd =
        rsqrtf(row_sum<WPR>(sv, 0.f, sm_red, turn).x / fd + p.eps);
    for (int off = 0; off < d; off += W) {
      C::load(xr, xrow, off, t, d);
#pragma unroll
      for (int j = 0; j < EPT / C::V; ++j) {
        float out[C::V];
#pragma unroll
        for (int k = 0; k < C::V; ++k) {
          const int i = j * C::V + k;
          const int c = C::col(off, t, i);
          const float s = c < d ? load_scale(p.scale, p.scale_code, c) : 0.f;
          const float b = c < d ? load_scale(p.bias, p.bias_code, c) : 0.f;
          out[k] = (to_f(xr[i]) - mean) * rstd * s + b;
        }
        C::store(yrow, out, off, t, d, j);
      }
    }
  }
}

using FwdKernel = void (*)(LnFwd);

// K1's instantiation for (wpr, ept, vec, wide), or null. With V = 16 /
// sizeof(T) (a 16-byte vector) and E = 4 V (32 for 2-byte types, 16 for
// f32): rows kernels at (1, V), (4, V), (4, 2 V), (4, E) and (1, E) (one
// warp a row at the widest, for launch-shape sweeps); wide kernels at
// (4, E) and (1, E).
template <typename T>
FwdKernel pick_fwd(int wpr, int ept, int vec, int wide) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int E = 4 * V;
#define FF_PICK(KERNEL, WPR, EPT)                                          \
  if (wpr == WPR && ept == EPT)                                            \
    return vec ? FwdKernel(KERNEL<T, WPR, EPT, true>)                      \
               : FwdKernel(KERNEL<T, WPR, EPT, false>);
  if (wide) {
    FF_PICK(ln_fwd_wide, 4, E)
    FF_PICK(ln_fwd_wide, 1, E)
    return nullptr;
  }
  FF_PICK(ln_fwd_rows, 1, V)
  FF_PICK(ln_fwd_rows, 4, V)
  FF_PICK(ln_fwd_rows, 4, 2 * V)
  FF_PICK(ln_fwd_rows, 4, E)
  FF_PICK(ln_fwd_rows, 1, E)
#undef FF_PICK
  return nullptr;
}

FwdKernel pick_fwd_type(int dtype, int wpr, int ept, int vec, int wide) {
  if (dtype == kF32) return pick_fwd<float>(wpr, ept, vec, wide);
  if (dtype == kBF16) return pick_fwd<__nv_bfloat16>(wpr, ept, vec, wide);
  if (dtype == kF16) return pick_fwd<__half>(wpr, ept, vec, wide);
  return nullptr;
}

using Kernel = void (*)(LnBwd);

// The instantiation for (wpr, ept, vec, wide), or null: EPT is 32 for
// 2-byte types and 16 for f32; wpr 1 or 4, and the wide kernel 4.
template <typename T>
Kernel pick(int wpr, int ept, int vec, int wide) {
  constexpr int E = sizeof(T) == 2 ? 32 : 16;
  if (ept != E) return nullptr;
  if (wide) {
    if (wpr != 4) return nullptr;
    return vec ? Kernel(ln_bwd_wide<T, E, true>)
               : Kernel(ln_bwd_wide<T, E, false>);
  }
  if (wpr == 1)
    return vec ? Kernel(ln_bwd_rows<T, 1, E, true>)
               : Kernel(ln_bwd_rows<T, 1, E, false>);
  if (wpr == 4)
    return vec ? Kernel(ln_bwd_rows<T, 4, E, true>)
               : Kernel(ln_bwd_rows<T, 4, E, false>);
  return nullptr;
}

Kernel pick_type(int dtype, int wpr, int ept, int vec, int wide) {
  if (dtype == kF32) return pick<float>(wpr, ept, vec, wide);
  if (dtype == kBF16) return pick<__nv_bfloat16>(wpr, ept, vec, wide);
  if (dtype == kF16) return pick<__half>(wpr, ept, vec, wide);
  return nullptr;
}

}  // namespace

// Plain C interface, bound by ctypes. Pointers are device pointers; x, dy
// and dx share dtype `x_dtype`; `part` holds grid * 2 * d floats of
// scratch; ds and db are f32 (d). The geometry (wpr, ept, vec, wide, grid)
// comes from the wrapper. Returns a cudaError_t code (0 = both launches
// accepted), or -1 for a geometry or dtype it was not built for.
extern "C" int ff_layer_norm_bwd(const void* x, const void* dy,
                                 const void* scale, void* dx, float* part,
                                 float* ds, float* db, long long n, int d,
                                 long long x_stride, long long dy_stride,
                                 long long dx_stride, int x_dtype,
                                 int scale_dtype, float eps, int wpr, int ept,
                                 int vec, int wide, int grid, void* stream) {
  Kernel k = pick_type(x_dtype, wpr, ept, vec, wide);
  if (k == nullptr || n < 1 || d < 1 || grid < 1 || scale_dtype < kF32 ||
      scale_dtype > kF16)
    return -1;
  // every CTA has a row (the wide kernel writes its partial row only
  // from its rows), and a row fits the rows kernel's registers
  if (wide ? grid > n : (d > 32 * wpr * ept || grid > (n + 3) / 4 * wpr))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  LnBwd p{x, dy, scale, dx, part, n, x_stride, dy_stride, dx_stride,
          d, scale_dtype, eps};
  k<<<grid, kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_colsum<<<(d + 31) / 32, kSumWarps * 32, 0, st>>>(part, grid, d, ds,
                                                          db);
  return (int)cudaGetLastError();
}

// CTAs of one instantiation that fit on an SM at once (the persistent
// grid's depth), or -1 for one it was not built for.
extern "C" int ff_layer_norm_bwd_occupancy(int x_dtype, int wpr, int ept,
                                           int vec, int wide) {
  Kernel k = pick_type(x_dtype, wpr, ept, vec, wide);
  if (k == nullptr) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}

// K1: y = (x - mean) rstd scale + bias over rows of x (n, d), y in x's
// dtype `x_dtype`, scale and bias each f32, bf16 or f16 (their own
// codes). The geometry (wpr, ept, vec, wide, grid) comes from the
// wrapper. Returns a cudaError_t code (0 = the launch was accepted), or -1
// for a geometry or dtype it was not built for.
extern "C" int ff_layer_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* y, long long n,
                                 int d, long long x_stride,
                                 long long y_stride, int x_dtype,
                                 int scale_dtype, int bias_dtype, float eps,
                                 int wpr, int ept, int vec, int wide,
                                 int grid, void* stream) {
  FwdKernel k = pick_fwd_type(x_dtype, wpr, ept, vec, wide);
  if (k == nullptr || n < 1 || d < 1 || grid < 1 || scale_dtype < kF32 ||
      scale_dtype > kF16 || bias_dtype < kF32 || bias_dtype > kF16 ||
      (!wide && d > 32 * wpr * ept))
    return -1;
  LnFwd p{x, scale, bias, y, n, x_stride, y_stride, d, scale_dtype,
          bias_dtype, eps};
  k<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// CTAs of one K1 instantiation that fit on an SM at once (the persistent
// grid's depth), or -1 for one it was not built for.
extern "C" int ff_layer_norm_fwd_occupancy(int x_dtype, int wpr, int ept,
                                           int vec, int wide) {
  FwdKernel k = pick_fwd_type(x_dtype, wpr, ept, vec, wide);
  if (k == nullptr) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}
