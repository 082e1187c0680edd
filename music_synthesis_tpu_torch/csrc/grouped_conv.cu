// Grouped, strided 1-D convolutions with few channels a group, for Hopper
// (sm_90a): the forward, the input gradient, and the weight gradient with
// the bias gradient (a second, small kernel that also finishes the weight
// gradient's sums in a fixed order).
//
// It replaces no TPU kernel: the JAX package lowers the MSD's grouped
// convolutions through XLA (`feature_group_count`). It was added because
// cuDNN runs these layers (groups 64 and 256, 4 input channels a group, 16
// or 4 outputs, kernel 41, stride 4) one group at a time or on its
// non-tensor-core kernels (`implicit_convolve_sgemm` 256 times for the
// group-256 forward, `dgrad2d_grouped_direct` for its input gradient),
// 2-4 ms a call for work of microseconds: at [32, 1024, 168] ->
// [32, 1024, 32] (groups 256) the forward is 0.344 GFLOP and 13.4 MB,
// 4.0 us of bytes at 3.35 TB/s and 5.1 us of fp32 FFMA at 67 TFLOP/s.
//
// The functions, for x [B, G*ci, Lp] (already padded), w [G*co, ci, K]
// (any strides), gy [B, G*co, To], To = (Lp - K) / s + 1:
//   y[b, g*co+o, t]    = bias[g*co+o] + sum_{c,k} w[g*co+o, c, k] x[b, g*ci+c, s t + k]
//   gx[b, g*ci+c, p]   = sum_{o, k, t: s t + k = p} w[g*co+o, c, k] gy[b, g*co+o, t]
//   gw[g*co+o, c, k]   = sum_{b,t} gy[b, g*co+o, t] x[b, g*ci+c, s t + k]
//   gb[g*co+o]         = sum_{b,t} gy[b, g*co+o, t]
// Every sum is fp32 in a fixed order (no atomics), rounded once to the
// working type (bf16 or fp32): a replay of a CUDA graph gives the bits of
// another replay and of the eager call.
//
// What bounds it on an H100: FFMA, at about 26 FLOP a byte (groups 256)
// and 78 (groups 64), at or above fp32's ridge (20 FLOP a byte). The work
// is small (5.1 us of FFMA at the group-256 layer's [32, 1024, 168]), so a
// call's time is mostly the latency of its staging and of few warps a SM;
// PERF.md gives the times. The design keeps the operands in shared memory
// and every output's sum in registers:
// - Forward: a block takes nb batch rows x gt groups x tt outputs; it
//   stages the groups' kernels as fp32 [group][c][k][o] (loads in the
//   kernel's own stride order, kLoads in flight a thread) and the input
//   strips in x's dtype split by phase (sample s t + k lies in phase
//   k mod s at index t + k / s; 16-byte loads where the rows are aligned,
//   split between the phases in registers). A thread computes opt outputs
//   x kUpt consecutive t: per phase it reads its window of kWin inputs as
//   16-byte vectors, then per tap one broadcast kernel word per output
//   feeds kUpt FFMA.
// - Input gradient: polyphase. Position p = s q + r takes the taps
//   k = r + s j at t = q - j. A block takes nb rows x gt groups x positions
//   s q0 .. s (q0 + qq) - 1; a thread computes cpt input channels x kUpt
//   consecutive q of one phase from a window of gy, stages its sums in
//   shared memory and the block writes them out in position order (16-byte
//   stores where aligned).
// - Weight gradient: a block takes gt groups and a run of bps batch rows,
//   nb rows x tt t's a load; a thread owns one (c, k) and opt outputs o,
//   reading x (k after k: consecutive words) and one broadcast 16-byte word
//   of gy per 4 outputs. Each block writes its fp32 partial sums; the
//   finishing kernel adds the runs' partials in order and sums gy per
//   channel (kBiasWarps warps a channel) for the bias.
// The tiles come from the caller (ops/grouped_conv.py: plan_forward,
// plan_input_grad, plan_weight_grad), which this file checks; a block
// launches the threads its tile uses, rounded up to a warp.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and called through ctypes (music_synthesis_tpu_torch/_build.py,
// ops/grouped_conv.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as Tensor.to does
}

// Lane j of a 16-byte vector of T as fp32, and a vector packed from fp32
// lanes (rounded to T), by shifts of its four words: no address is taken,
// so the vectors stay in registers. j is a constant after unrolling.
__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T>
__device__ __forceinline__ float lane(const uint4& v, int j);
template <>
__device__ __forceinline__ float lane<float>(const uint4& v, int j) {
  return __uint_as_float(word_of(v, j));
}
template <>
__device__ __forceinline__ float lane<__nv_bfloat16>(const uint4& v, int j) {
  return __uint_as_float((word_of(v, j >> 1) >> (16 * (j & 1))) << 16);
}
template <typename T>
__device__ __forceinline__ unsigned bits(float v);
template <>
__device__ __forceinline__ unsigned bits<float>(float v) {
  return __float_as_uint(v);
}
template <>
__device__ __forceinline__ unsigned bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
template <typename T, typename Get>
__device__ __forceinline__ uint4 pack(Get get) {
  unsigned w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits<T>(get(i));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bits<T>(get(2 * i)) | (bits<T>(get(2 * i + 1)) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__host__ __device__ __forceinline__ int div_up(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// i / d for 0 <= i < 2^31 by one multiply-high: m = ceil(2^32 / d), exact
// while i < 2^32 / d (always, for the sizes valid_shape allows).
struct FastDiv {
  unsigned m;
  int d;
  __device__ __forceinline__ explicit FastDiv(int d_)
      : m(d_ == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(d_) + 1u),
        d(d_) {}
  __device__ __forceinline__ int operator()(int i) const {
    return d == 1 ? i : static_cast<int>(__umulhi(static_cast<unsigned>(i), m));
  }
};

// The shape of one call.
struct Shape {
  int batch, groups, ci, co, K, stride, Lp, To;
  int ws0, ws1, ws2;  // w's strides (elements): output, input channel, tap
};

// Loads elements p0 .. p0 + n - 1 of `rows` rows into shared memory
// through put(row, i, value): row r starts at row_ptr(r); positions
// outside 0 .. len - 1 read 0. With vec, 16-byte loads: the caller
// promises p0 and len multiples of the vector and every row 16-byte
// aligned, so that a vector lies wholly inside or outside its row.
template <typename T, typename RowPtr, typename Put>
__device__ __forceinline__ void load_rows(RowPtr row_ptr, int rows, int p0,
                                          int n, int len, bool vec,
                                          Put put) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int chunks = div_up(n, V);
    const FastDiv by_chunks(chunks);
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = by_chunks(idx), ch = idx - r * chunks;
      const int p = p0 + ch * V;
      const uint4 raw = p >= 0 && p < len
                            ? *reinterpret_cast<const uint4*>(row_ptr(r) + p)
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (ch * V + j < n) put(r, ch * V + j, lane<T>(raw, j));
      }
    }
  } else {
    const FastDiv by_n(n);
    for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
      const int r = by_n(idx), i = idx - r * n;
      const int p = p0 + i;
      put(r, i, p >= 0 && p < len ? to_float(row_ptr(r)[p]) : 0.0f);
    }
  }
}

// Stores get(row, i) to positions p0 + i (i < n, and before len) of `rows`
// rows; vec as for load_rows.
template <typename T, typename RowPtr, typename Get>
__device__ __forceinline__ void store_rows(RowPtr row_ptr, int rows, int p0,
                                           int n, int len, bool vec,
                                           Get get) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int chunks = div_up(n, V);
    const FastDiv by_chunks(chunks);
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int r = by_chunks(idx), ch = idx - r * chunks;
      const int p = p0 + ch * V;
      if (p >= len) continue;
      *reinterpret_cast<uint4*>(row_ptr(r) + p) =
          pack<T>([&](int j) { return get(r, ch * V + j); });
    }
  } else {
    const FastDiv by_n(n);
    for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
      const int r = by_n(idx), i = idx - r * n;
      if (p0 + i < len) row_ptr(r)[p0 + i] = from_float<T>(get(r, i));
    }
  }
}

// Stages the kernels of groups g0 .. g0 + ng - 1 in shared memory as
// fp32 through put(o_local, c, k, value), reading w in the order of its
// smallest stride (o fastest for WNConv's permuted kernel, k fastest for a
// contiguous one) so that a warp's loads are coalesced, kLoads loads in
// flight a thread.
constexpr int kLoads = 8;
template <typename T, typename Put>
__device__ __forceinline__ void load_kernels(const T* __restrict__ w,
                                             const Shape& sh, int g0, int ng,
                                             Put put) {
  const int n_o = ng * sh.co, taps = sh.ci * sh.K, n = n_o * taps;
  const bool o_fastest = sh.ws0 < sh.ws2;
  const FastDiv by_k(sh.K), by_inner(o_fastest ? n_o : taps);
  const T* wg = w + static_cast<size_t>(g0) * sh.co * sh.ws0;
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kLoads * nt) {
    float v[kLoads];
    int ol[kLoads], tap[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * nt;
      const int outer = by_inner(i), inner = i - outer * (o_fastest ? n_o
                                                                    : taps);
      ol[u] = o_fastest ? inner : outer;
      tap[u] = o_fastest ? outer : inner;
      const int c = by_k(tap[u]), k = tap[u] - c * sh.K;
      v[u] = i < n ? to_float(wg[ol[u] * sh.ws0 + c * sh.ws1 + k * sh.ws2])
                   : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u * nt < n) {
        const int c = by_k(tap[u]);
        put(ol[u], c, tap[u] - c * sh.K, v[u]);
      }
    }
  }
}

// Fills phase rows from rows of x: row r (row_ptr(r), of len samples)
// gives its samples p0 + s m + ph (m < per_phase) to
// dst(r) + ph * row_len + m, in x's dtype; samples outside 0 .. len - 1
// give 0. With vec and a stride dividing the 16-byte vector (the caller
// promises p0 and len multiples of the vector and the rows aligned), one
// 16-byte load a vector, kLoads in flight a thread, split between the
// phases in registers; else one sample at a time.
template <typename T, typename RowPtr, typename Dst>
__device__ __forceinline__ void load_phases(RowPtr row_ptr, Dst dst,
                                            int rows, int p0, int s,
                                            int per_phase, int row_len,
                                            int len, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int n = s * per_phase;
  const FastDiv by_s(s);
  if (vec && V % s == 0 && per_phase % (V / s) == 0) {
    const int chunks = n / V, per = V / s;
    const int total = rows * chunks;
    const FastDiv by_chunks(chunks);
    const int nt = blockDim.x;
    for (int base = threadIdx.x; base < total; base += kLoads * nt) {
      uint4 raw[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * nt;
        const int r = by_chunks(idx), p = p0 + (idx - r * chunks) * V;
        raw[u] = idx < total && p < len
                     ? *reinterpret_cast<const uint4*>(row_ptr(r) + p)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * nt;
        if (idx >= total) continue;
        const int r = by_chunks(idx), ch = idx - r * chunks;
        T* d = dst(r) + ch * per;
#pragma unroll
        for (int j = 0; j < V; ++j) {  // sample j of the vector: phase j % s
          const int m = by_s(j);
          d[(j - m * s) * row_len + m] = from_float<T>(lane<T>(raw[u], j));
        }
      }
    }
  } else {
    const FastDiv by_n(n);
    for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
      const int r = by_n(idx), i = idx - r * n;
      const int p = p0 + i, m = by_s(i);
      dst(r)[(i - m * s) * row_len + m] =
          p < len ? row_ptr(r)[p] : from_float<T>(0.0f);
    }
  }
}

// acc[j] += row[j] * v for j < N, row in shared memory (16-byte aligned
// when N is a multiple of 4).
template <int N>
__device__ __forceinline__ void fma_row(float (&acc)[N], const float* row,
                                        float v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 w = *reinterpret_cast<const float4*>(row + j);
      acc[j] = fmaf(w.x, v, acc[j]);
      acc[j + 1] = fmaf(w.y, v, acc[j + 1]);
      acc[j + 2] = fmaf(w.z, v, acc[j + 2]);
      acc[j + 3] = fmaf(w.w, v, acc[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = fmaf(row[j], v, acc[j]);
  }
}

// The forward and the input gradient run each thread over kUpt
// consecutive outputs along t (q), reading a window of kWin inputs (gy
// values) from shared memory as 16-byte vectors: the first kUpt + J - 1
// of them feed the J <= kJMax taps of a phase.
constexpr int kUpt = 8;
constexpr int kJMax = 16;
constexpr int kWin = kUpt + kJMax;

// Elements of T between two (batch row, group) pairs' rows in shared
// memory: their bytes rounded up to 128, plus 64, so that the two pairs a
// quarter-warp reads lie in other banks.
__host__ __device__ __forceinline__ int pair_stride(int elems, int size) {
  return ((elems * size + 127) / 128 * 128 + 64) / size;
}

// Shared memory of each kernel in bytes (grouped_conv_smem returns it to
// ops/grouped_conv.py's plans, which size their tiles by it).
// Forward: the kernels [gt][ci][K][co] fp32, then per pair ci * s phase
// rows of tt + kJMax inputs in x's dtype.
__host__ __device__ __forceinline__ int fwd_row(int tt) { return tt + kJMax; }
__host__ __device__ __forceinline__ int fwd_pair(const Shape& sh, int tt,
                                                 int size) {
  return pair_stride(sh.ci * sh.stride * fwd_row(tt), size);
}
size_t fwd_smem(const Shape& sh, int gt, int nb, int tt, int size) {
  return sizeof(float) * static_cast<size_t>(
                             round4(gt * sh.ci * sh.K * sh.co)) +
         static_cast<size_t>(size) * nb * gt * fwd_pair(sh, tt, size);
}
// Input gradient: the kernels [gt][co][K][ci] fp32, the staged outputs
// per pair [ci][s][QS] fp32 (QS = qq rounded up to 32, plus 8: a warp's
// reads in position order hit 32 banks), then per pair co rows of
// qq + kWin - kUpt gy values in gy's dtype.
__host__ __device__ __forceinline__ int igrad_row(int qq) {
  return qq + kWin - kUpt;
}
__host__ __device__ __forceinline__ int igrad_qs(int qq) {
  return (qq + 31) / 32 * 32 + 8;
}
__host__ __device__ __forceinline__ int igrad_pair(const Shape& sh, int qq,
                                                   int size) {
  return pair_stride(sh.co * igrad_row(qq), size);
}
size_t igrad_smem(const Shape& sh, int gt, int nb, int qq, int size) {
  return sizeof(float) * (static_cast<size_t>(
                              round4(gt * sh.co * sh.K * sh.ci)) +
                          static_cast<size_t>(nb) * gt * sh.ci * sh.stride *
                              igrad_qs(qq)) +
         static_cast<size_t>(size) * nb * gt * igrad_pair(sh, qq, size);
}
__host__ __device__ __forceinline__ int wgrad_gy_words(const Shape& sh,
                                                       int tt) {
  return tt * sh.co + 4;  // + 4: two groups' words in other banks
}
__host__ __device__ __forceinline__ int wgrad_x_len(const Shape& sh, int tt) {
  return sh.stride * (tt - 1) + sh.K;
}
size_t wgrad_smem(const Shape& sh, int gt, int tt, int nb) {
  return sizeof(float) * static_cast<size_t>(nb) * gt *
         (wgrad_gy_words(sh, tt) +
          static_cast<size_t>(sh.ci) * wgrad_x_len(sh, tt));
}

// n (a multiple of the vector) elements of T at p, 16-byte aligned, as
// fp32.
template <typename T, int N>
__device__ __forceinline__ void load_window(const T* p, float (&v)[N]) {
  constexpr int V = 16 / sizeof(T);
  static_assert(N % V == 0, "a window is whole vectors");
#pragma unroll
  for (int i = 0; i < N; i += V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
    for (int j = 0; j < V; ++j) v[i + j] = lane<T>(raw, j);
  }
}

template <int N>
__device__ __forceinline__ void load_weights(const float* p, float (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      w[i] = v.x;
      w[i + 1] = v.y;
      w[i + 2] = v.z;
      w[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = p[i];
  }
}

// y = conv(x, w) + bias. Block: batch rows b0 .. b0 + nb - 1, groups
// g0 .. g0 + gt - 1, outputs t0 .. t0 + tt - 1; thread: kUpt consecutive t
// fastest, then the chunk of VPT outputs, then the group, then the row.
// Phase row r of channel c holds the strip's samples s t0 + r + s i.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    gc_forward_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ y, Shape sh,
                      int gt, int nb, int tt, int n_gtile, int n_ttile,
                      int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ci = sh.ci, co = sh.co, K = sh.K, s = sh.stride;
  const int RS = fwd_row(tt), PS = fwd_pair(sh, tt, sizeof(T));
  float* ws = smem;  // [gt][ci][K][co]
  T* xs = reinterpret_cast<T*>(smem + round4(gt * ci * K * co));
  int bid = blockIdx.x;
  const int tile_t = bid % n_ttile;
  bid /= n_ttile;
  const int tile_g = bid % n_gtile, tile_b = bid / n_gtile;
  const int t0 = tile_t * tt, g0 = tile_g * gt, b0 = tile_b * nb;
  const int ng = min(gt, sh.groups - g0), nbr = min(nb, sh.batch - b0);
  const int cin = sh.groups * ci, cout = sh.groups * co;

  const FastDiv by_co(co), by_rows(ng * ci), by_ci(ci);
  load_kernels(w, sh, g0, ng, [&](int ol, int c, int k, float v) {
    const int gl = by_co(ol);
    ws[((gl * ci + c) * K + k) * co + ol - gl * co] = v;
  });
  // Row r of the strip: batch row b0 + r / (ng ci), channel r % (ng ci).
  const T* xb = x + (static_cast<size_t>(b0) * cin +
                     static_cast<size_t>(g0) * ci) *
                        sh.Lp;
  load_phases<T>(
      [&](int r) {
        const int bl = by_rows(r);
        return xb + (static_cast<size_t>(bl) * cin + r - bl * ng * ci) *
                        sh.Lp;
      },
      [&](int r) {
        const int bl = by_rows(r), rr = r - bl * ng * ci;
        const int gl = by_ci(rr);
        return xs + (bl * gt + gl) * PS + (rr - gl * ci) * s * RS;
      },
      nbr * ng * ci, s * t0, s, RS, RS, sh.Lp, vec != 0);
  __syncthreads();

  const int n_t = tt / kUpt, n_chunk = co / VPT;
  const int tl = threadIdx.x % n_t;
  int rest = threadIdx.x / n_t;
  const int oc = rest % n_chunk;
  rest /= n_chunk;
  const int gl = rest % gt, bl = rest / gt;
  const int t = t0 + tl * kUpt;
  if (bl >= nbr || gl >= ng || t >= sh.To) return;
  float acc[VPT][kUpt];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
#pragma unroll
    for (int u = 0; u < kUpt; ++u) acc[v][u] = 0.0f;
  }
  const T* xp = xs + (bl * gt + gl) * PS + tl * kUpt;
  for (int c = 0; c < ci; ++c) {
    for (int r = 0; r < s; ++r) {
      const int J = div_up(K - r, s);
      float xf[kWin];
      load_window(xp + (c * s + r) * RS, xf);
      const float* wp = ws + ((gl * ci + c) * K + r) * co + oc * VPT;
#pragma unroll
      for (int j = 0; j < kJMax; ++j) {
        if (j < J) {
          float wv[VPT];
          load_weights(wp + j * s * co, wv);
#pragma unroll
          for (int v = 0; v < VPT; ++v) {
#pragma unroll
            for (int u = 0; u < kUpt; ++u) {
              acc[v][u] = fmaf(wv[v], xf[u + j], acc[v][u]);
            }
          }
        }
      }
    }
  }
  const int o0 = (g0 + gl) * co + oc * VPT;
  T* yo = y + (static_cast<size_t>(b0 + bl) * cout + o0) * sh.To + t;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const float bv = bias != nullptr ? to_float(bias[o0 + v]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kUpt; ++u) {
      if (t + u < sh.To) {
        yo[static_cast<size_t>(v) * sh.To + u] = from_float<T>(acc[v][u] + bv);
      }
    }
  }
}

// gx = the transposed convolution of gy. Block: batch rows b0 .. b0 + nb
// - 1, groups g0 .. g0 + gt - 1, positions s q0 .. s (q0 + qq) - 1;
// thread: kUpt consecutive q fastest, then the phase r, then the chunk of
// VPT input channels, then the group, then the row. Position s q + r takes
// taps r + s j at t = q - j; row i of a pair's gy holds t = q0 - (kWin -
// kUpt) + i, so a thread's window starts at its own q's offset.
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    gc_input_grad_kernel(const T* __restrict__ gy, const T* __restrict__ w,
                         T* __restrict__ gx, Shape sh, int gt, int nb, int qq,
                         int n_gtile, int n_qtile, int vec_gy, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLead = kWin - kUpt;
  const int ci = sh.ci, co = sh.co, K = sh.K, s = sh.stride;
  const int GR = igrad_row(qq), QS = igrad_qs(qq);
  const int GP = igrad_pair(sh, qq, sizeof(T)), OP = ci * s * QS;
  float* ws = smem;                             // [gt][co][K][ci]
  float* outs = smem + round4(gt * co * K * ci);  // [pair][ci][s][QS]
  T* gys = reinterpret_cast<T*>(outs + nb * gt * OP);  // [pair][co][GR]
  int bid = blockIdx.x;
  const int tile_q = bid % n_qtile;
  bid /= n_qtile;
  const int tile_g = bid % n_gtile, tile_b = bid / n_gtile;
  const int q0 = tile_q * qq, g0 = tile_g * gt, b0 = tile_b * nb;
  const int ng = min(gt, sh.groups - g0), nbr = min(nb, sh.batch - b0);
  const int cin = sh.groups * ci, cout = sh.groups * co;

  const FastDiv by_gyrows(ng * co), by_co(co), by_xrows(ng * ci),
      by_ci(ci), by_s(s);
  load_kernels(w, sh, g0, ng, [&](int ol, int c, int k, float v) {
    ws[(ol * K + k) * ci + c] = v;
  });
  const T* gb = gy + (static_cast<size_t>(b0) * cout +
                      static_cast<size_t>(g0) * co) *
                         sh.To;
  load_rows<T>(
      [&](int r) {
        const int bl = by_gyrows(r);
        return gb + (static_cast<size_t>(bl) * cout + r - bl * ng * co) *
                        sh.To;
      },
      nbr * ng * co, q0 - kLead, GR, sh.To, vec_gy != 0,
      [&](int r, int i, float v) {
        const int bl = by_gyrows(r), rr = r - bl * ng * co;
        const int gl = by_co(rr), o = rr - gl * co;
        gys[(bl * gt + gl) * GP + o * GR + i] = from_float<T>(v);
      });
  __syncthreads();

  const int n_q = qq / kUpt, n_chunk = ci / VPT;
  const int tl = threadIdx.x % n_q;
  int rest = threadIdx.x / n_q;
  const int r = rest % s;
  rest /= s;
  const int cc = rest % n_chunk;
  rest /= n_chunk;
  const int gl = rest % gt, bl = rest / gt;
  const int pair = bl * gt + gl;
  if (bl < nbr && gl < ng) {
    const int J = div_up(K - r, s);
    float acc[VPT][kUpt];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
#pragma unroll
      for (int u = 0; u < kUpt; ++u) acc[v][u] = 0.0f;
    }
    for (int o = 0; o < co; ++o) {
      float gf[kWin];
      load_window(gys + pair * GP + o * GR + tl * kUpt, gf);
      const float* wp = ws + ((gl * co + o) * K + r) * ci + cc * VPT;
#pragma unroll
      for (int j = 0; j < kJMax; ++j) {
        if (j < J) {
          float wv[VPT];
          load_weights(wp + j * s * ci, wv);
#pragma unroll
          for (int v = 0; v < VPT; ++v) {
#pragma unroll
            for (int u = 0; u < kUpt; ++u) {
              acc[v][u] = fmaf(wv[v], gf[kLead + u - j], acc[v][u]);
            }
          }
        }
      }
    }
    float* op = outs + pair * OP + (cc * VPT * s + r) * QS + tl * kUpt;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
#pragma unroll
      for (int u = 0; u < kUpt; ++u) op[v * s * QS + u] = acc[v][u];
    }
  }
  __syncthreads();
  T* xb = gx + (static_cast<size_t>(b0) * cin +
                static_cast<size_t>(g0) * ci) *
                   sh.Lp;
  store_rows<T>(
      [&](int row) {
        const int b = by_xrows(row);
        return xb + (static_cast<size_t>(b) * cin + row - b * ng * ci) *
                        sh.Lp;
      },
      nbr * ng * ci, s * q0, s * qq, sh.Lp, vec != 0, [&](int row, int i) {
        const int b = by_xrows(row), rr = row - b * ng * ci;
        const int g = by_ci(rr), c = rr - g * ci;
        const int q = by_s(i);
        return outs[(b * gt + g) * OP + (c * s + i - q * s) * QS + q];
      });
}

// The weight gradient's partial sums over batch rows b0 .. b0 + bps - 1:
// partial[split][g*co + o][c][k]. Block: groups g0 .. g0 + gt - 1 and the
// split-th run of rows, taken nb rows x tt t's at a time (one load, one
// barrier, then the sums); thread: (c, k) fastest, then the chunk of OPT
// outputs, then the group.
template <typename T, int OPT>
__global__ void __launch_bounds__(kThreads)
    gc_weight_grad_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          float* __restrict__ partial, Shape sh, int gt,
                          int tt, int nb, int bps, int n_gtile, int vec_x,
                          int vec_gy) {
  extern __shared__ __align__(16) float smem[];
  const int ci = sh.ci, co = sh.co, K = sh.K, s = sh.stride;
  const int GS = wgrad_gy_words(sh, tt), SX = wgrad_x_len(sh, tt);
  float* gys = smem;                 // [nb][gt][tt][co] (+ 4 words a group)
  float* xs = smem + nb * gt * GS;   // [nb][gt * ci][SX]
  const int tile_g = blockIdx.x % n_gtile, split = blockIdx.x / n_gtile;
  const int g0 = tile_g * gt, ng = min(gt, sh.groups - g0);
  const int b0 = split * bps, b1 = min(sh.batch, b0 + bps);
  const int cin = sh.groups * ci, cout = sh.groups * co;
  const FastDiv by_xrows(ng * ci), by_gyrows(ng * co), by_co(co);

  const int taps = ci * K, n_chunk = co / OPT, per_group = n_chunk * taps;
  const int gl = threadIdx.x / per_group;
  const int rem = threadIdx.x - gl * per_group;
  const int oc = rem / taps, tap = rem - oc * taps;
  const int c = tap / K, k = tap - c * K;
  const bool active = gl < ng;
  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.0f;
  for (int bb = b0; bb < b1; bb += nb) {
    const int nbr = min(nb, b1 - bb);
    const T* xb =
        x + (static_cast<size_t>(bb) * cin + static_cast<size_t>(g0) * ci) *
                sh.Lp;
    const T* gb =
        gy + (static_cast<size_t>(bb) * cout + static_cast<size_t>(g0) * co) *
                 sh.To;
    for (int t0 = 0; t0 < sh.To; t0 += tt) {
      __syncthreads();  // the previous tile's reads are done
      // Row r of the tile is batch row bb + r / (ng ci), channel r % (ng ci).
      load_rows<T>(
          [&](int r) {
            const int bl = by_xrows(r);
            return xb + (static_cast<size_t>(bl) * cin + r - bl * ng * ci) *
                            sh.Lp;
          },
          nbr * ng * ci, s * t0, SX, sh.Lp, vec_x != 0,
          [&](int r, int i, float v) {
            const int bl = by_xrows(r);
            xs[(bl * gt * ci + r - bl * ng * ci) * SX + i] = v;
          });
      load_rows<T>(
          [&](int r) {
            const int bl = by_gyrows(r);
            return gb + (static_cast<size_t>(bl) * cout + r - bl * ng * co) *
                            sh.To;
          },
          nbr * ng * co, t0, tt, sh.To, vec_gy != 0,
          [&](int r, int i, float v) {
            const int bl = by_gyrows(r), rr = r - bl * ng * co;
            const int g = by_co(rr);
            gys[(bl * gt + g) * GS + i * co + rr - g * co] = v;
          });
      __syncthreads();
      if (active) {
        const int nt = min(tt, sh.To - t0);
        for (int bl = 0; bl < nbr; ++bl) {
          const float* xp = xs + (bl * gt * ci + gl * ci + c) * SX + k;
          const float* gp = gys + (bl * gt + gl) * GS + oc * OPT;
          for (int tl = 0; tl < nt; ++tl) {
            fma_row<OPT>(acc, gp + tl * co, xp[s * tl]);
          }
        }
      }
    }
  }
  if (!active) return;
  float* out = partial + (static_cast<size_t>(split) * cout +
                          (g0 + gl) * co + oc * OPT) *
                             taps +
               tap;
#pragma unroll
  for (int j = 0; j < OPT; ++j) out[static_cast<size_t>(j) * taps] = acc[j];
}

// gw from the partial sums (the runs added in order), and gb: kBiasWarps
// warps a channel, warp w summing batch rows w, w + kBiasWarps, ... (lane
// l the rows' t = l, l + 32, ...), then a butterfly and the warps' sums
// added in order. Blocks 0 .. w_blocks - 1 take gw, the rest gb.
constexpr int kBiasWarps = 4;
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gc_weight_grad_finish(const float* __restrict__ partial,
                          const T* __restrict__ gy, T* __restrict__ gw,
                          T* __restrict__ gb, Shape sh, int n_split,
                          int w_blocks) {
  __shared__ float sums[kWarps];
  const int cout = sh.groups * sh.co;
  if (static_cast<int>(blockIdx.x) < w_blocks) {
    const int n_w = cout * sh.ci * sh.K;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (gw == nullptr || i >= n_w) return;
    float acc = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      acc += partial[static_cast<size_t>(sp) * n_w + i];
    }
    gw[i] = from_float<T>(acc);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int oc = (blockIdx.x - w_blocks) * (kWarps / kBiasWarps) +
                 warp / kBiasWarps;
  const int part = warp % kBiasWarps;
  float acc = 0.0f;
  if (oc < cout) {
#pragma unroll 4
    for (int b = part; b < sh.batch; b += kBiasWarps) {
      const T* row = gy + (static_cast<size_t>(b) * cout + oc) * sh.To;
      for (int t = lane; t < sh.To; t += 32) acc += to_float(row[t]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) sums[warp] = acc;
  __syncthreads();
  if (part == 0 && lane == 0 && oc < cout) {
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < kBiasWarps; ++j) total += sums[warp + j];
    gb[oc] = from_float<T>(total);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool valid_shape(const Shape& sh) {
  const long long cin = static_cast<long long>(sh.groups) * sh.ci;
  const long long cout = static_cast<long long>(sh.groups) * sh.co;
  return sh.batch >= 1 && sh.groups >= 1 && sh.ci >= 1 && sh.co >= 1 &&
         sh.K >= 1 && sh.stride >= 1 && sh.Lp >= sh.K &&
         sh.To == (sh.Lp - sh.K) / sh.stride + 1 &&
         sh.batch * cin * sh.Lp <= 0x7fffffffLL &&
         sh.batch * cout * sh.To <= 0x7fffffffLL &&
         cout * sh.ci * sh.K <= 0x7fffffffLL;
}

bool per_thread_ok(int n, int of) {
  return (n == 1 || n == 2 || n == 4 || n == 8 || n == 16) && of % n == 0;
}

// Runs fn(std::integral_constant-like tag) for the per-thread count n in
// {1, 2, 4, 8, 16}.
template <int N>
struct Count {
  static constexpr int value = N;
};
template <typename F>
cudaError_t by_count(int n, F fn) {
  switch (n) {
    case 1: return fn(Count<1>{});
    case 2: return fn(Count<2>{});
    case 4: return fn(Count<4>{});
    case 8: return fn(Count<8>{});
    case 16: return fn(Count<16>{});
    default: return cudaErrorInvalidValue;
  }
}

Shape make_shape(int batch, int groups, int ci, int co, int K, int stride,
                 int Lp, int To, int ws0, int ws1, int ws2) {
  Shape sh;
  sh.batch = batch;
  sh.groups = groups;
  sh.ci = ci;
  sh.co = co;
  sh.K = K;
  sh.stride = stride;
  sh.Lp = Lp;
  sh.To = To;
  sh.ws0 = ws0;
  sh.ws1 = ws1;
  sh.ws2 = ws2;
  return sh;
}

template <typename T>
cudaError_t forward(const void* x, const void* w, const void* bias, void* y,
                    const Shape& sh, int opt, int gt, int nb, int tt, int vec,
                    cudaStream_t stream) {
  const int n_gtile = div_up(sh.groups, gt), n_ttile = div_up(sh.To, tt);
  const long long blocks =
      static_cast<long long>(div_up(sh.batch, nb)) * n_gtile * n_ttile;
  const size_t smem = fwd_smem(sh, gt, nb, tt, sizeof(T));
  if (blocks > 0x7fffffffLL || smem > static_cast<size_t>(kMaxSmem)) {
    return cudaErrorInvalidValue;
  }
  const int threads = div_up(nb * gt * (sh.co / opt) * (tt / kUpt), 32) * 32;
  return by_count(opt, [&](auto n) {
    constexpr int N = decltype(n)::value;
    if constexpr (N > 4) {
      return cudaErrorInvalidValue;
    } else {
      auto kernel = gc_forward_kernel<T, N>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(bias), static_cast<T*>(y), sh, gt, nb, tt,
          n_gtile, n_ttile, vec);
      return cudaGetLastError();
    }
  });
}

template <typename T>
cudaError_t input_grad(const void* gy, const void* w, void* gx,
                       const Shape& sh, int cpt, int gt, int nb, int qq,
                       int vec_gy, int vec, cudaStream_t stream) {
  const int n_gtile = div_up(sh.groups, gt);
  const int n_qtile = div_up(div_up(sh.Lp, sh.stride), qq);
  const long long blocks =
      static_cast<long long>(div_up(sh.batch, nb)) * n_gtile * n_qtile;
  const size_t smem = igrad_smem(sh, gt, nb, qq, sizeof(T));
  if (blocks > 0x7fffffffLL || smem > static_cast<size_t>(kMaxSmem)) {
    return cudaErrorInvalidValue;
  }
  const int threads =
      div_up(nb * gt * (sh.ci / cpt) * sh.stride * (qq / kUpt), 32) * 32;
  return by_count(cpt, [&](auto n) {
    constexpr int N = decltype(n)::value;
    if constexpr (N > 4) {
      return cudaErrorInvalidValue;
    } else {
      auto kernel = gc_input_grad_kernel<T, N>;
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
          static_cast<const T*>(gy), static_cast<const T*>(w),
          static_cast<T*>(gx), sh, gt, nb, qq, n_gtile, n_qtile, vec_gy,
          vec);
      return cudaGetLastError();
    }
  });
}

template <typename T>
cudaError_t weight_grad(const void* x, const void* gy, float* partial,
                        void* gw, void* gb, const Shape& sh, int opt, int gt,
                        int tt, int nb, int bps, int vec_x, int vec_gy,
                        cudaStream_t stream) {
  const int n_gtile = div_up(sh.groups, gt);
  const int n_split = div_up(sh.batch, bps);
  const size_t smem = wgrad_smem(sh, gt, tt, nb);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (gw != nullptr) {
    const cudaError_t err = by_count(opt, [&](auto n) {
      constexpr int N = decltype(n)::value;
      auto kernel = gc_weight_grad_kernel<T, N>;
      cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      const int threads = div_up(gt * (sh.co / N) * sh.ci * sh.K, 32) * 32;
      kernel<<<n_gtile * n_split, threads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(gy), partial, sh,
          gt, tt, nb, bps, n_gtile, vec_x, vec_gy);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  const int cout = sh.groups * sh.co;
  const int w_blocks =
      gw != nullptr ? div_up(cout * sh.ci * sh.K, kThreads) : 0;
  const int b_blocks =
      gb != nullptr ? div_up(cout, kWarps / kBiasWarps) : 0;
  gc_weight_grad_finish<T><<<w_blocks + b_blocks, kThreads, 0, stream>>>(
      partial, static_cast<const T*>(gy), static_cast<T*>(gw),
      static_cast<T*>(gb), sh, n_split, w_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [batch, groups * co, To] = the grouped convolution of x [batch,
// groups * ci, Lp] (contiguous) with w [groups * co, ci, K] (strides ws0,
// ws1, ws2 in elements) at `stride`, plus bias [groups * co] (nullable),
// all of dtype 0 (fp32) or 1 (bf16). Tiles (plan_forward): opt outputs by
// kUpt t's a thread, nb batch rows x gt groups x tt outputs a block, the
// block's threads at most 256; ceil(K / stride) <= kJMax. vec != 0
// promises x 16-byte aligned, Lp and stride * tt multiples of 16 / element
// size. Launches on `stream` without synchronising; returns the first CUDA
// error (0 on success).
int grouped_conv_forward(const void* x, const void* w, const void* bias,
                         void* y, int dtype, int batch, int groups, int ci,
                         int co, int K, int stride, int Lp, int To, int ws0,
                         int ws1, int ws2, int opt, int gt, int nb, int tt,
                         int vec, void* stream) {
  const Shape sh =
      make_shape(batch, groups, ci, co, K, stride, Lp, To, ws0, ws1, ws2);
  if ((dtype != 0 && dtype != 1) || !valid_shape(sh) ||
      !per_thread_ok(opt, co) || opt > 4 || div_up(K, stride) > kJMax ||
      gt < 1 || gt > groups || nb < 1 || nb > batch || tt < kUpt ||
      tt % kUpt != 0 ||
      static_cast<long long>(nb) * gt * (co / opt) * (tt / kUpt) >
          kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0
          ? forward<float>(x, w, bias, y, sh, opt, gt, nb, tt, vec, s)
          : forward<__nv_bfloat16>(x, w, bias, y, sh, opt, gt, nb, tt, vec,
                                   s));
}

// gx [batch, groups * ci, Lp] = the input gradient of grouped_conv_forward
// from gy [batch, groups * co, To] (contiguous) and w (strides ws0..2).
// Tiles (plan_input_grad): cpt input channels by kUpt positions of a phase
// a thread, nb batch rows x gt groups x stride * qq positions a block.
// vec_gy != 0 promises gy 16-byte aligned, To and qq multiples of 16 /
// element size; vec != 0 gx aligned, Lp and stride * qq multiples of it.
int grouped_conv_input_grad(const void* gy, const void* w, void* gx,
                            int dtype, int batch, int groups, int ci, int co,
                            int K, int stride, int Lp, int To, int ws0,
                            int ws1, int ws2, int cpt, int gt, int nb, int qq,
                            int vec_gy, int vec, void* stream) {
  const Shape sh =
      make_shape(batch, groups, ci, co, K, stride, Lp, To, ws0, ws1, ws2);
  if ((dtype != 0 && dtype != 1) || !valid_shape(sh) ||
      !per_thread_ok(cpt, ci) || cpt > 4 || div_up(K, stride) > kJMax ||
      gt < 1 || gt > groups || nb < 1 || nb > batch || qq < kUpt ||
      qq % kUpt != 0 ||
      static_cast<long long>(nb) * gt * (ci / cpt) * stride * (qq / kUpt) >
          kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? input_grad<float>(gy, w, gx, sh, cpt, gt, nb, qq, vec_gy,
                                     vec, s)
                 : input_grad<__nv_bfloat16>(gy, w, gx, sh, cpt, gt, nb, qq,
                                             vec_gy, vec, s));
}

// Shared memory bytes of a launch: kind 0 the forward (a = gt, b = nb,
// c = tt), 1 the input gradient (gt, nb, qq), 2 the weight gradient
// (gt, tt, nb); -1 for an invalid shape. ops/grouped_conv.py's plans fit
// their tiles to a block by it.
long long grouped_conv_smem(int kind, int dtype, int groups, int ci, int co,
                            int K, int stride, int a, int b, int c) {
  const Shape sh = make_shape(1, groups, ci, co, K, stride, K, 1, 0, 0, 0);
  const int size = dtype == 0 ? 4 : 2;
  switch (kind) {
    case 0: return static_cast<long long>(fwd_smem(sh, a, b, c, size));
    case 1: return static_cast<long long>(igrad_smem(sh, a, b, c, size));
    case 2: return static_cast<long long>(wgrad_smem(sh, a, b, c));
    default: return -1;
  }
}

// gw [groups * co, ci, K] (contiguous; nullable) and gb [groups * co]
// (nullable; not both null) of grouped_conv_forward from x and gy (both
// contiguous). gw goes through `partial` (ceil(batch / bps) * groups * co
// * ci * K floats; may be null when gw is) and the finishing kernel, which
// also sums gb. Tiles (plan_weight_grad): opt outputs a thread, gt groups
// a block, nb batch rows x tt t's a load, bps batch rows a run. vec_x != 0
// promises x 16-byte aligned, Lp and stride * tt multiples of 16 / element
// size; vec_gy != 0 gy aligned, To and tt multiples of it.
int grouped_conv_weight_grad(const void* x, const void* gy, float* partial,
                             void* gw, void* gb, int dtype, int batch,
                             int groups, int ci, int co, int K, int stride,
                             int Lp, int To, int opt, int gt, int tt, int nb,
                             int bps, int vec_x, int vec_gy, void* stream) {
  const Shape sh =
      make_shape(batch, groups, ci, co, K, stride, Lp, To, 0, 0, 0);
  if ((dtype != 0 && dtype != 1) || !valid_shape(sh) ||
      !per_thread_ok(opt, co) || gt < 1 || gt > groups || tt < 1 ||
      nb < 1 || bps < 1 || gt * (co / opt) * ci * K > kThreads ||
      (gw == nullptr && gb == nullptr) ||
      (gw != nullptr && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? weight_grad<float>(x, gy, partial, gw, gb, sh, opt, gt,
                                      tt, nb, bps, vec_x, vec_gy, s)
                 : weight_grad<__nv_bfloat16>(x, gy, partial, gw, gb, sh,
                                              opt, gt, tt, nb, bps, vec_x,
                                              vec_gy, s));
}

}  // extern "C"
