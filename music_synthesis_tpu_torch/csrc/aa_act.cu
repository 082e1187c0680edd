// Anti-aliased SnakeBeta (BigVGAN's activation) for Hopper (sm_90a): one
// kernel for the forward pass, one for the backward (and a small second one
// that sums the per-channel parameter gradients in a fixed order).
//
// It replaces no TPU kernel: the JAX package has no BigVGAN. It was added
// because the plain PyTorch version (ops/alias_free.py: replicate pads, a
// depthwise conv_transpose1d, sin, square, divide, add, a depthwise
// conv1d, and autograd over all of it after a recompute) moves each byte
// about fifteen times over, at twice the signal's length, in ~20 kernels a
// call.
//
// The function, per row (b, c) of x [B, C, L], with h the 12-tap
// kaiser_sinc() filter, alpha = exp(a[c]), beta = exp(b[c]):
//   u[m] = 2 sum_e h[m + 5 - 2e] x[clamp(e, 0, L-1)],     m in [0, 2L)
//          (upsample2: replicate pad 5, conv_transpose1d stride 2, crop 15)
//   s[m] = u + sin(alpha u)^2 / (beta + 1e-9)
//   y[t] = sum_k h[k] s[clamp(2t + k - 5, 0, 2L-1)],       t in [0, L)
//          (downsample2: replicate pad 5 left and 6 right, conv1d stride 2)
// Only taps with 0 <= m + 5 - 2e <= 11 exist, six per doubled-rate sample.
// The backward is the transpose: gs = D^T gy at the doubled rate (the
// gradient of a padded sample folded into the end sample it copies),
// gu = gs (1 + alpha sin(2 alpha u) / (beta + eps)), gx = U^T gu with the
// same fold; alpha's and beta's gradients are sums of gs times their
// derivatives over every doubled-rate sample of the channel.
//
// What bounds it on an H100. Its bytes: x read and y written forward, x and
// gy read and gx written backward, 10 bytes a sample in bf16 (BigVGAN's 109
// activations a step at [32, 8192] move 6.29 GB, 1.88 ms at 3.35 TB/s). Its
// instructions bound it harder: ~50 fp32 instructions a doubled-rate sample
// forward and ~75 backward, a third to a half of them in sinf / sincosf,
// so it runs at a sixth to a seventh of the bytes' rate (PERF.md §6).
// The design keeps everything at the doubled rate out of device memory and
// spends as few instructions as it can around the sines:
// - A block takes a tile of `rows_per_block` rows x `span` outputs (the
//   wrapper picks both from L: about 2048 outputs a block, some 3,000
//   blocks at batch 32). It reads its rows once, with 8 inputs of halo
//   before and 16 after, 16 bytes a load where the rows are aligned, into
//   fp32 shared memory; inputs outside the row are the row's end sample
//   (x: the clamp is the replicate pad) or zero (gy).
// - Threads compute 8 doubled-rate samples at a time from a window of 10
//   inputs held in registers (polyphase: even samples take the odd taps,
//   odd ones the even) and apply SnakeBeta; the 10 samples of halo the
//   downsampling reads beyond them are computed one by one, so that a
//   thread takes two groups of 8. The downsampling then reads 26 samples
//   into registers per 8 outputs and applies the 12 taps at stride 2. Rows
//   of shared memory carry one pad word every 4 inputs or 16 doubled-rate
//   samples, so that these windows are read without bank conflicts.
// - The backward recomputes u from x in registers, forms gs from gy with
//   the same windows, and writes gu to shared memory; gx is the forward's
//   second half again. The replicate pads' transposes at a row's ends are
//   a few fixed taps, computed once a row. The ga / gb partial sums go to a
//   scratch tensor per (row, tile) and a second kernel adds them per
//   channel in a fixed order: no atomics, so a replay gives the bits of
//   another replay and of the eager call.
// - Accurate sinf / sincosf / expf (no fast math). Arguments past sinf's
//   fast range are first reduced modulo pi (at mod_pi).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and called through ctypes (music_synthesis_tpu_torch/_build.py,
// ops/alias_free.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 12;
constexpr int kLead = 8;    // input samples a row holds before the tile
constexpr int kTail = 16;   // and after it
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-9f;  // upstream's no_div_by_zero
constexpr int kDefaultSmem = 48 * 1024;
// rows_per_block * (span + kLead + kTail) at most: the inputs of a tile,
// which the threads hold in registers as 16-byte chunks (Chunks).
constexpr int kTileInputs = 2304;

// Logical -> physical index in a row of inputs (one pad word every 4: a
// thread reads its 10-input window 4 inputs after its neighbour's, so the
// physical stride is 5) and of doubled-rate samples (one every 16: a thread
// reads its 26 samples 16 after its neighbour's, physical stride 17).
__host__ __device__ __forceinline__ int px(int p) { return p + (p >> 2); }
__host__ __device__ __forceinline__ int ps(int p) { return p + (p >> 4); }

// Words of one row: inputs t0 - kLead .. t0 + span + kTail - 1, and
// doubled-rate samples 2 t0 - 8 .. 2 t0 + 2 span + 7.
__host__ __device__ __forceinline__ int x_words(int span) {
  const int n = span + kLead + kTail;  // a multiple of 8
  return n + n / 4;
}
__host__ __device__ __forceinline__ int s_words(int span) {
  const int n = 2 * span + 16;  // a multiple of 16
  return n + n / 16;
}
// The doubled-rate samples a row computes: the threads take logical
// 8 .. 2 span + 7 in groups of 8 (two groups a thread at the wrapper's
// tiles), and the 10 the downsampling reads around them, logical 3 .. 7
// and 2 span + 8 .. 2 span + 12, one by one.
__host__ __device__ __forceinline__ int up_groups(int span) {
  return span / 4;
}
constexpr int kHalo = 10;
__device__ __forceinline__ int halo_sample(int k, int span) {
  return k < 5 ? 3 + k : 2 * span + 3 + k;
}
// The first single a thread takes: those with one group fewer go first.
__device__ __forceinline__ int first_single(int groups) {
  return (threadIdx.x + kThreads - groups % kThreads) % kThreads;
}

// The windows the threads read, with px / ps folded into constant offsets
// from a base: inputs 4q + 1 .. 4q + 10 of a row (logical), doubled-rate
// samples 2o + 3 .. 2o + 28 for o a multiple of 8, and the physical index
// of doubled-rate sample 8q + i (i < 8).
__device__ __forceinline__ void window10(const float* row, int q, float* w) {
  const float* p = row + 5 * q;
#pragma unroll
  for (int j = 0; j < 10; ++j) w[j] = p[1 + j + ((1 + j) >> 2)];
}
__device__ __forceinline__ void window26(const float* row, int o, float* w) {
  const float* p = row + 17 * (o >> 3);
#pragma unroll
  for (int k = 0; k < 26; ++k) w[k] = p[3 + k + ((3 + k) >> 4)];
}
__device__ __forceinline__ int ps8(int q, int i) {
  return 8 * q + (q >> 1) + i;
}

// sinf's own argument reduction is fast up to |x| = 105615 and takes a
// slow path (Payne-Hanek, through local memory) past it. BigVGAN's
// activations reach that in training (in the benchmark's run |alpha u|
// passes 1e5 within ten steps and 1e11 within twenty), so the kernel
// reduces such an argument itself. It needs only sin(x)^2 and
// sin(2x) = 2 sin(x) cos(x), both of period pi: x - k pi with
// k = rint(x / pi), in fp64 with pi in two parts (Cody-Waite), exact to
// about 5e-16 for |x| < 2^42; then the accurate sinf / sincosf of the
// reduced argument. Past 2^42 sinf takes its own path.
constexpr float kFastTrig = 105615.0f;
constexpr float kReduceMax = 4398046511104.0f;  // 2^42
constexpr double kInvPi = 0.318309886183790671538;
constexpr double kPiHi = 3.141592653589793116;       // double(pi)
constexpr double kPiLo = 1.2246467991473532072e-16;  // pi - kPiHi

__device__ __forceinline__ float mod_pi(float x) {
  const float ax = fabsf(x);
  if (ax > kFastTrig && ax < kReduceMax) {
    const double xd = x;
    const double k = rint(xd * kInvPi);
    return static_cast<float>(fma(-k, kPiLo, fma(-k, kPiHi, xd)));
  }
  return x;
}

size_t smem_bytes(int rows_per_block, int span, bool backward) {
  const size_t r = static_cast<size_t>(rows_per_block);
  size_t words = r * (x_words(span) + s_words(span)) + 2 * r;  // + alpha, inv
  if (backward) words += r * x_words(span) + 2 * r + 2 * r * up_groups(span);
  return words * sizeof(float);
}

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

// A tile: rows r0 .. r0 + nr - 1, outputs t0 .. t0 + tn - 1 of each, the
// col-th span of the rows. Block i takes tile i, columns fastest.
struct Tile {
  int r0, nr, t0, tn, col;
};

__device__ __forceinline__ Tile tile_at(int i, int rows, int L,
                                        int rows_per_block, int span,
                                        int n_col) {
  Tile t;
  t.col = i % n_col;
  t.r0 = (i / n_col) * rows_per_block;
  t.nr = min(rows_per_block, rows - t.r0);
  t.t0 = t.col * span;
  t.tn = min(span, L - t.t0);
  return t;
}

// A tile's inputs t0 - kLead .. t0 + span + kTail - 1 of each row as 16-byte
// chunks, chunk i of the tile in c[j] of thread i - j * kThreads: all of a
// thread's loads are in flight at once. The rows must be 16-byte aligned
// and L a multiple of the chunk: then a chunk lies wholly inside or
// outside its row, and those outside are not loaded (fill_ends).
template <typename T>
struct Chunks {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kMax = (kTileInputs / V + kThreads - 1) / kThreads;
  uint4 c[kMax];
};

template <typename T>
__device__ __forceinline__ void fetch(Chunks<T>& ch,
                                      const T* __restrict__ src,
                                      const Tile& t, int span, int L) {
  constexpr int V = Chunks<T>::V;
  const int per_row = (span + kLead + kTail) / V;
#pragma unroll
  for (int j = 0; j < Chunks<T>::kMax; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < t.nr * per_row) {
      const int r = i / per_row;
      const int s = t.t0 - kLead + (i - r * per_row) * V;
      if (s >= 0 && s < L) {
        ch.c[j] = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(t.r0 + r) * L + s));
      }
    }
  }
}

// Writes the chunks into dst as fp32 (rows of x_words(span) floats).
template <typename T>
__device__ __forceinline__ void put(const Chunks<T>& ch, float* dst,
                                    const Tile& t, int span) {
  constexpr int V = Chunks<T>::V;
  const int per_row = (span + kLead + kTail) / V, xw = x_words(span);
#pragma unroll
  for (int j = 0; j < Chunks<T>::kMax; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < t.nr * per_row) {
      const int r = i / per_row, p = (i - r * per_row) * V;
      const T* e = reinterpret_cast<const T*>(&ch.c[j]);
      float* d = dst + r * xw;
#pragma unroll
      for (int k = 0; k < V; ++k) d[px(p + k)] = to_float(e[k]);
    }
  }
}

// The inputs outside the row, which no chunk brought: the row's first or
// last sample (the replicate pad) or zero. Returns whether it wrote any
// (the same in every thread): then a barrier has to follow.
__device__ __forceinline__ bool fill_ends(float* dst, const Tile& t, int span,
                                          int L, bool zero) {
  const int n = span + kLead + kTail, xw = x_words(span);
  const int left = t.t0 == 0 ? kLead : 0;          // p < left: t < 0
  const int right = max(0, t.t0 - kLead + n - L);  // p >= n - right: t >= L
  const int per_row = left + right;
  for (int i = threadIdx.x; i < t.nr * per_row; i += kThreads) {
    const int r = i / per_row, j = i - r * per_row;
    float* d = dst + r * xw;
    if (j < left) {
      d[px(j)] = zero ? 0.0f : d[px(kLead)];
    } else {
      d[px(n - right + j - left)] =
          zero ? 0.0f : d[px(L - 1 - t.t0 + kLead)];
    }
  }
  return per_row > 0;
}

// The same rows sample by sample (rows not 16-byte aligned): clamped to the
// row (replicate) or zero outside it.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, float* dst,
                          const Tile& t, int span, int L, bool zero) {
  const int n = span + kLead + kTail, xw = x_words(span);
  for (int i = threadIdx.x; i < t.nr * n; i += kThreads) {
    const int r = i / n, p = i - r * n;
    const int s = t.t0 - kLead + p;
    const T* row = src + static_cast<size_t>(t.r0 + r) * L;
    float v;
    if (zero) {
      v = (s >= 0 && s < L) ? to_float(row[s]) : 0.0f;
    } else {
      v = to_float(row[min(max(s, 0), L - 1)]);
    }
    dst[r * xw + px(p)] = v;
  }
}

// One tile's rows of src into dst (the clamp or the zero outside the
// rows included), by chunks when `vec`, else sample by sample.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      const Tile& t, int span, int L,
                                      bool zero, bool vec) {
  if (vec) {
    Chunks<T> ch;
    fetch(ch, src, t, span, L);
    put(ch, dst, t, span);
  } else {
    load_rows(src, dst, t, span, L, zero);
  }
}

// The upsampling's transposed convolution for 8 doubled-rate samples
// 8q .. 8q + 7 of a row (logical, sample 2 t0 - 8 first) from the inputs
// 4q + 1 .. 4q + 10 of the row (logical, input t0 - kLead first), without
// the factor 2: even samples take the odd taps, odd ones the even.
__device__ __forceinline__ void up8(const float* h, const float* w,
                                    float* out) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float even = 0.0f, odd = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      even = fmaf(h[11 - 2 * j], w[p + j], even);
      odd = fmaf(h[10 - 2 * j], w[p + 1 + j], odd);
    }
    out[2 * p] = even;
    out[2 * p + 1] = odd;
  }
}

// The same sum for one doubled-rate sample m_l (logical, >= 3) of a row, in
// the same order.
__device__ __forceinline__ float up_one(const float* h, const float* row,
                                        int m_l) {
  const int e0 = (m_l + 3) >> 1;  // the first input with a tap
  float acc = 0.0f;
  if (m_l & 1) {  // odd samples take the even taps
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc = fmaf(h[10 - 2 * j], row[px(e0 + j)], acc);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      acc = fmaf(h[11 - 2 * j], row[px(e0 + j)], acc);
    }
  }
  return acc;
}

// The downsampling's 12 taps at stride 2 for 8 outputs from 26 doubled-rate
// samples: out[i] = sum_k h[k] w[2i + k].
__device__ __forceinline__ void down8(const float* h, const float* w,
                                      float* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc = fmaf(h[k], w[2 * i + k], acc);
    out[i] = acc;
  }
}

// Writes `count` (<= 8) outputs: 16 bytes a store when `vec`.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* v, int count,
                                       bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int i = 0; i < count; i += V) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = from_float<T>(v[i + j]);
      *reinterpret_cast<uint4*>(dst + i) = raw;
    }
  } else {
    for (int i = 0; i < count; ++i) dst[i] = from_float<T>(v[i]);
  }
}

// Per row of the tile: alpha = exp(a[c]) and 1 / (exp(b[c]) + eps), in
// coef[stride * r] and the word after it.
__device__ __forceinline__ void row_coefs(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float* coef, int stride,
                                          const Tile& t, int channels) {
  for (int r = threadIdx.x; r < t.nr; r += kThreads) {
    const int c = (t.r0 + r) % channels;
    coef[stride * r] = expf(a[c]);
    coef[stride * r + 1] = 1.0f / (expf(b[c]) + kEps);
  }
}

// The replicate pads transposed, at a row's ends. The downsampling's: the
// gradients of the doubled-rate samples -5 .. -1, which copy sample 0, and
// of 2L .. 2L + 4, which copy 2L - 1, sum_t h[m + 5 - 2t] gy[t] over the
// row's first or last 3 inputs (gr: the tile's gy row, logical input
// kLead is t0). The upsampling's: the gradients of inputs -3 .. -1, which
// copy input 0, and of L .. L + 2, which copy L - 1, sum_k h[k]
// gu[2e + k - 5] over the m = 2e + k - 5 inside the row (ur: the tile's gu
// row, logical 8 is 2 t0), without the factor 2. The taps that reach an
// end are fixed, so the loops unroll.
__device__ __forceinline__ float gs_fold_first(const float* h,
                                               const float* gr, int L) {
  float acc = 0.0f;
#pragma unroll
  for (int m = -5; m <= -1; ++m) {
#pragma unroll
    for (int t = 0; t <= 2; ++t) {
      const int k = m + 5 - 2 * t;
      if (k >= 0 && t < L) acc = fmaf(h[k], gr[px(kLead + t)], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float gs_fold_last(const float* h,
                                              const float* gr, int L,
                                              int t0) {
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a <= 4; ++a) {  // m = 2L + a
#pragma unroll
    for (int b = 0; b <= 2; ++b) {  // t = L - 1 - b
      const int k = a + 7 + 2 * b;
      if (k < kTaps && L - 1 - b >= 0) {
        acc = fmaf(h[k], gr[px(L - 1 - b - t0 + kLead)], acc);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float gx_fold_first(const float* h,
                                               const float* ur, int L) {
  float acc = 0.0f;
#pragma unroll
  for (int e = -3; e <= -1; ++e) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int m = 2 * e + k - 5;
      if (m >= 0 && m < 2 * L) acc = fmaf(h[k], ur[ps(m + 8)], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float gx_fold_last(const float* h,
                                              const float* ur, int L,
                                              int t0) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 1; j <= 3; ++j) {  // e = L - 1 + j
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const int m = 2 * (L - 1 + j) + k - 5;
      if (2 * j + k - 7 < 0 && m >= 0) {  // m < 2L
        acc = fmaf(h[k], ur[ps(m - 2 * t0 + 8)], acc);
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    aa_forward_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ taps, T* __restrict__ y,
                      int rows, int channels, int L, int rows_per_block,
                      int span, int n_col, int vec) {
  extern __shared__ float smem[];
  const int xw = x_words(span), sw = s_words(span);
  float* xs = smem;
  float* ss = xs + rows_per_block * xw;
  float* coef = ss + rows_per_block * sw;  // [row][alpha, inv]
  float h[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) h[k] = __ldg(taps + k);
  const Tile t = tile_at(blockIdx.x, rows, L, rows_per_block, span, n_col);
  row_coefs(a, b, coef, 2, t, channels);
  stage(x, xs, t, span, L, false, vec != 0);
  __syncthreads();
  if (vec && fill_ends(xs, t, span, L, false)) __syncthreads();

  // Upsampling and SnakeBeta, 8 doubled-rate samples a step (group q holds
  // logical 8 q + 8 ..), then the halo's samples one by one.
  const int gu = up_groups(span);
  for (int g = threadIdx.x; g < t.nr * gu; g += kThreads) {
    const int r = g / gu, q = g - r * gu + 1;
    float w[10], u[8];
    window10(xs + r * xw, q, w);
    up8(h, w, u);
    const float alpha = coef[2 * r], inv = coef[2 * r + 1];
    float* sr = ss + r * sw;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = 2.0f * u[k];
      const float sn = sinf(mod_pi(v * alpha));
      sr[ps8(q, k)] = fmaf(sn * sn, inv, v);
    }
  }
  for (int j = first_single(t.nr * gu); j < t.nr * kHalo; j += kThreads) {
    const int r = j / kHalo, m_l = halo_sample(j - r * kHalo, span);
    const float v = 2.0f * up_one(h, xs + r * xw, m_l);
    const float sn = sinf(mod_pi(v * coef[2 * r]));
    ss[r * sw + ps(m_l)] = fmaf(sn * sn, coef[2 * r + 1], v);
  }
  __syncthreads();

  // The downsampling's replicate pad: samples before the row's first
  // (m = -5 .. -1) and after its last (2L .. 2L + 4) repeat those. Outputs
  // 0 .. 2 read the first, L - 3 .. L - 1 the second (whichever tiles hold
  // them; the last sample a tile reads is logical 2 span + 12).
  const bool first = t.t0 == 0, last = t.t0 + t.tn + 3 > L;
  if (first || last) {
    const int end = 2 * (L - t.t0) + kLead;  // logical 2L
    for (int j = threadIdx.x; j < t.nr * 10; j += kThreads) {
      const int r = j / 10, k = j - r * 10;
      float* sr = ss + r * sw;
      if (k < 5 && first) {
        sr[ps(kLead - 1 - k)] = sr[ps(kLead)];
      } else if (k >= 5 && last && end + k - 5 < 2 * span + 16) {
        sr[ps(end + k - 5)] = sr[ps(end - 1)];
      }
    }
    __syncthreads();
  }

  // Downsampling, 8 outputs a step: y[t] reads logical samples
  // 2 (t - t0) + 3 .. 2 (t - t0) + 14.
  const int gd = span / 8;
  for (int g = threadIdx.x; g < t.nr * gd; g += kThreads) {
    const int r = g / gd, o = 8 * (g - r * gd);
    if (o >= t.tn) continue;
    float w[26], out[8];
    window26(ss + r * sw, o, w);
    down8(h, w, out);
    store8(y + static_cast<size_t>(t.r0 + r) * L + t.t0 + o, out,
           min(8, t.tn - o), vec != 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    aa_backward_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ taps, T* __restrict__ gx,
                       float* __restrict__ partial, int rows, int channels,
                       int L, int rows_per_block, int span, int n_col,
                       int vec) {
  extern __shared__ float smem[];
  const int xw = x_words(span), sw = s_words(span), gu = up_groups(span);
  float* xs = smem;
  float* gys = xs + rows_per_block * xw;
  float* us = gys + rows_per_block * xw;  // gu at the doubled rate
  float* coef = us + rows_per_block * sw;  // [row][alpha, inv, fold, fold]
  float* red = coef + 4 * rows_per_block;  // [row][group][a | b]
  float h[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) h[k] = __ldg(taps + k);
  const Tile t = tile_at(blockIdx.x, rows, L, rows_per_block, span, n_col);
  const int m_first = 2 * t.t0 - 8;  // the doubled-rate sample at logical 0
  // Which ends of the rows the tile's doubled-rate samples reach: then the
  // gradients of the padded samples fold into m = 0 or m = 2L - 1.
  const bool first = t.t0 == 0, last = 2 * L - 1 < m_first + 2 * span + 16;
  row_coefs(a, b, coef, 4, t, channels);
  for (int r = threadIdx.x; r < t.nr; r += kThreads) {
    coef[4 * r + 2] = coef[4 * r + 3] = 0.0f;
  }
  stage(x, xs, t, span, L, false, vec != 0);
  stage(gy, gys, t, span, L, true, vec != 0);
  __syncthreads();
  bool filled = false;
  if (vec) {
    filled = fill_ends(xs, t, span, L, false);
    fill_ends(gys, t, span, L, true);
  }
  if (first || last) {  // the folds read gy inside the rows only
    for (int r = threadIdx.x; r < t.nr; r += kThreads) {
      const float* gr = gys + r * xw;
      if (first) coef[4 * r + 2] = gs_fold_first(h, gr, L);
      if (last) coef[4 * r + 3] = gs_fold_last(h, gr, L, t.t0);
    }
  }
  if (filled || first || last) __syncthreads();

  // gu at the doubled rate (zero outside the row), 8 samples a step and
  // the halo's one by one, as the forward's; the partial sums of alpha's
  // and beta's gradients over the tile's own samples (logical 8 .. 8 +
  // 2 tn - 1; the halo and the rest are other tiles' own).
  for (int g = threadIdx.x; g < t.nr * gu; g += kThreads) {
    const int r = g / gu, q = g - r * gu + 1;
    float w[10], u[8], gs[8];
    window10(xs + r * xw, q, w);
    up8(h, w, u);
    window10(gys + r * xw, q, w);
    up8(h, w, gs);  // D^T gy
    const float alpha = coef[4 * r], inv = coef[4 * r + 1];
    const float fold_first = coef[4 * r + 2], fold_last = coef[4 * r + 3];
    float* ur = us + r * sw;
    float pa = 0.0f, pb = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int m_l = 8 * q + k, m = m_first + m_l;
      const float g_s = gs[k] + (m == 0 ? fold_first : 0.0f) +
                        (m == 2 * L - 1 ? fold_last : 0.0f);
      const float v = 2.0f * u[k];
      float sn, cs;
      sincosf(mod_pi(v * alpha), &sn, &cs);
      const float d = 2.0f * sn * cs * inv;  // sin(2 alpha u) / (beta + eps)
      const bool inside = m >= 0 && m < 2 * L;
      ur[ps8(q, k)] = inside ? g_s * fmaf(alpha, d, 1.0f) : 0.0f;
      const bool own = m_l >= kLead && m_l < kLead + 2 * t.tn;
      pa = own ? fmaf(g_s * v, d, pa) : pa;
      pb = own ? fmaf(g_s * sn, sn, pb) : pb;
    }
    if (partial != nullptr) {
      red[2 * g] = pa;
      red[2 * g + 1] = pb;
    }
  }
  for (int j = first_single(t.nr * gu); j < t.nr * kHalo; j += kThreads) {
    const int r = j / kHalo, m_l = halo_sample(j - r * kHalo, span);
    const int m = m_first + m_l;
    const float g_s = up_one(h, gys + r * xw, m_l) +
                      (m == 0 ? coef[4 * r + 2] : 0.0f) +
                      (m == 2 * L - 1 ? coef[4 * r + 3] : 0.0f);
    const float alpha = coef[4 * r], v = 2.0f * up_one(h, xs + r * xw, m_l);
    float sn, cs;
    sincosf(mod_pi(v * alpha), &sn, &cs);
    const float d = 2.0f * sn * cs * coef[4 * r + 1];
    us[r * sw + ps(m_l)] =
        m >= 0 && m < 2 * L ? g_s * fmaf(alpha, d, 1.0f) : 0.0f;
  }
  __syncthreads();

  // Per row of the tile, its partial sums in a fixed order: each lane a
  // strided run of groups, then a butterfly over the warp.
  if (partial != nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < t.nr; r += kWarps) {
      float sa = 0.0f, sb = 0.0f;
      for (int q = lane; q < gu; q += 32) {
        sa += red[2 * (r * gu + q)];
        sb += red[2 * (r * gu + q) + 1];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, off);
        sb += __shfl_xor_sync(0xffffffffu, sb, off);
      }
      if (lane == 0) {
        float* p =
            partial + 2 * (static_cast<size_t>(t.r0 + r) * n_col + t.col);
        p[0] = sa;
        p[1] = sb;
      }
    }
  }
  if (gx == nullptr) return;

  // gx = U^T gu: the forward's downsampling pattern, times 2; input 0 and
  // input L - 1 also take the gradients of the inputs their pads copy.
  const int gd = span / 8;
  for (int g = threadIdx.x; g < t.nr * gd; g += kThreads) {
    const int r = g / gd, o = 8 * (g - r * gd);
    if (o >= t.tn) continue;
    const float* ur = us + r * sw;
    float w[26], out[8];
    window26(ur, o, w);
    down8(h, w, out);
    const int count = min(8, t.tn - o);
    const float fold_first = t.t0 + o == 0 ? gx_fold_first(h, ur, L) : 0.0f;
    const float fold_last =
        t.t0 + o + count == L ? gx_fold_last(h, ur, L, t.t0) : 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      out[n] = 2.0f * (out[n] + (n == 0 ? fold_first : 0.0f) +
                       (n == count - 1 ? fold_last : 0.0f));
    }
    store8(gx + static_cast<size_t>(t.r0 + r) * L + t.t0 + o, out, count,
           vec != 0);
  }
}

// alpha's and beta's gradients [C] from the partial sums [B, C, n_col, 2]:
// one warp a channel, each lane a strided run, then a butterfly.
__global__ void __launch_bounds__(kThreads)
    aa_param_grad_kernel(const float* __restrict__ partial,
                         const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ ga,
                         float* __restrict__ gb, int batch, int channels,
                         int n_col) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (c >= channels) return;
  const int n = batch * n_col;
  float sa = 0.0f, sb = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const int bi = i / n_col, col = i - bi * n_col;
    const float* p =
        partial + 2 * ((static_cast<size_t>(bi) * channels + c) * n_col + col);
    sa += p[0];
    sb += p[1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (lane == 0) {
    const float alpha = expf(a[c]), beta = expf(b[c]);
    const float inv = 1.0f / (beta + kEps);
    if (ga != nullptr) ga[c] = alpha * sa;
    if (gb != nullptr) gb[c] = -(beta * inv * inv) * sb;
  }
}

// The tiles come from the caller (ops/alias_free.py::tiling): n_col spans
// cover a row exactly, `blocks` tiles cover the rows.
bool valid(int dtype, int batch, int channels, int length,
           int rows_per_block, int span, int n_col, int blocks) {
  return (dtype == 0 || dtype == 1) && batch >= 1 && channels >= 1 &&
         length >= 1 && rows_per_block >= 1 && span >= 8 && span % 8 == 0 &&
         static_cast<long long>(rows_per_block) * (span + kLead + kTail) <=
             kTileInputs &&
         n_col >= 1 && static_cast<long long>(n_col) * span >= length &&
         static_cast<long long>(n_col - 1) * span < length && blocks >= 1 &&
         static_cast<long long>(batch) * channels <= 0x7fffffffLL &&
         static_cast<long long>(length) + span + kTail <= 0x3fffffffLL;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// y = the activation of x, both [batch, channels, length] contiguous, of
// dtype 0 (fp32) or 1 (bf16); a, b [channels] fp32 (log-scale alpha,
// beta), taps [12] fp32. `blocks` blocks, block i taking rows_per_block
// rows x span outputs (span a multiple of 8) at tile_at(i): n_col spans a
// row. vec != 0 promises x and y 16-byte aligned and length a multiple of
// 16 / element size. Launches on `stream` without synchronising; returns
// the first CUDA error (0 on success).
int aa_act_forward(const void* x, const float* a, const float* b,
                   const float* taps, void* y, int dtype, int batch,
                   int channels, int length, int rows_per_block, int span,
                   int n_col, int blocks, int vec, void* stream) {
  if (!valid(dtype, batch, channels, length, rows_per_block, span, n_col,
             blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = batch * channels;
  const size_t smem = smem_bytes(rows_per_block, span, false);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = allow_smem(aa_forward_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    aa_forward_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), a, b, taps, static_cast<float*>(y),
        rows, channels, length, rows_per_block, span, n_col, vec);
  } else {
    err = allow_smem(aa_forward_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    aa_forward_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), a, b, taps,
        static_cast<__nv_bfloat16*>(y), rows, channels, length,
        rows_per_block, span, n_col, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of aa_act_forward from x and gy (same dtype, layout and
// tiles): gx (nullable: not asked for), and ga, gb [channels] fp32 (either
// nullable; both null: no parameter gradient), the latter through
// `partial` (2 * batch * channels * n_col floats, a pair per row and span;
// may be null when ga and gb are) and a second kernel. vec != 0 promises
// x, gy and gx 16-byte aligned. Returns the first CUDA error (0 on
// success).
int aa_act_backward(const void* x, const void* gy, const float* a,
                    const float* b, const float* taps, void* gx,
                    float* partial, float* ga, float* gb, int dtype,
                    int batch, int channels, int length, int rows_per_block,
                    int span, int n_col, int blocks, int vec, void* stream) {
  const bool params = ga != nullptr || gb != nullptr;
  if (!valid(dtype, batch, channels, length, rows_per_block, span, n_col,
             blocks) ||
      (params && partial == nullptr) || (!params && gx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!params) partial = nullptr;
  const int rows = batch * channels;
  const size_t smem = smem_bytes(rows_per_block, span, true);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = allow_smem(aa_backward_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    aa_backward_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gy), a, b,
        taps, static_cast<float*>(gx), partial, rows, channels, length,
        rows_per_block, span, n_col, vec);
  } else {
    err = allow_smem(aa_backward_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    aa_backward_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy), a, b, taps,
        static_cast<__nv_bfloat16*>(gx), partial, rows, channels, length,
        rows_per_block, span, n_col, vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !params) return static_cast<int>(err);
  const int warps_per_block = kThreads / 32;
  aa_param_grad_kernel<<<(channels + warps_per_block - 1) / warps_per_block,
                         kThreads, 0, s>>>(partial, a, b, ga, gb, batch,
                                           channels, n_col);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
