// Fused log-mel front-end for Hopper (sm_90a), one kernel launch per call.
//
// Replaces the TPU kernel music_synthesis_tpu/ops/pallas_frontend.py::_kernel
// (driven by _pallas_log_mel_core, pl.pallas_call at pallas_frontend.py:207).
// It computes the same function: for every frame i of clip b,
//   x      = wav[b, i*hop : i*hop + n_fft]            (read in place)
//   re, im = x @ C, x @ S      (Hann-windowed real-DFT bases, [n_fft, n_bins])
//   p      = re^2 + im^2       (or sqrt of it for magnitude mode)
//   out    = log(eps + p @ M)  (Slaney mel matrix, [n_bins, n_mels])
// Frames are never materialised in device memory, and the power spectrum
// never leaves the block: it goes from registers through shared memory into
// the mel product.
//
// What bounds it on an H100: arithmetic. At n_fft = 1024 the rDFT is
// 2 * 1024 * 1026 ~ 2.1 MFLOP per frame against ~4 KB of new input, far above
// the card's ridge point; in fp32 FFMA (67 TFLOP/s) the rDFT GEMM sets the
// bound (~17 us for 512 frames, ~183 us for 5,504).
//
// What the design does about it:
// - The grid is (frame tiles) x (chunks of 128 bins), so even the training
//   shape (16 clips x 32 frames) gives enough blocks to fill the card.
// - A block is 4 warps. A thread keeps an 8-frame x 4-bin register tile of
//   re and im (32 frames per block): per sample it reads two 128-bit words
//   of frames (the same address across the warp: a broadcast) and two of
//   bases (consecutive across the warp: no bank conflict) for 64 FFMAs, so
//   shared memory keeps up with the FFMA pipes. Where 32-frame tiles would
//   give fewer than two blocks per SM, the launcher takes 4-frame register
//   tiles (16 frames per block) instead, for more blocks and warps.
// - The next stage's samples and bases are prefetched into registers while
//   the current stage computes.
// - Each block writes its chunk's partial mel sums to a workspace; the last
//   block of a frame tile to finish (a counter per tile) adds the partials in
//   chunk order and applies the log, so the result is deterministic.
// - Only bins up to the last one with a non-zero mel weight are computed
//   (bin 512 of a 1024-point DFT has none).
//
// Precision: both of the wrapper's modes ("exact" and "fast") run this fp32
// FFMA path. A bf16x3 or 3xTF32 tensor-core path for "fast", wgmma, TMA and a
// shared-memory ring of bases are later work.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// and called through ctypes (music_synthesis_tpu_torch/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBinsPerLane = 4;                // a thread's bin columns
constexpr int kChunk = 32 * kBinsPerLane;      // 128 bins per block
constexpr int kKC = 8;                         // samples per pipeline stage
constexpr int kMaxMels = 128;
constexpr int kMelsPerLane = kMaxMels / 32;    // 4
constexpr int kPsStride = kChunk + 4;          // keeps rows 16-byte aligned
constexpr int kWarps = 4;                      // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSmallTile = 16;                 // frames per block, small grids

// A block of kWarps warps owns kFpw * kWarps frames; each thread keeps
// kFpw frames x kBinsPerLane bins of re and im.
template <int kFpw>
struct Tile {
  static constexpr int kFrames = kFpw * kWarps;
  static constexpr int kXsStride = kFrames + 4;            // 16-byte rows
  static constexpr int kXsPerThread = kKC * kFrames / kThreads;
  static constexpr int kColsPerThread = 2 * kChunk / kThreads;
  static_assert(kFpw % 4 == 0, "frames are read as float4");
  static_assert(kXsPerThread * kThreads == kKC * kFrames, "frame staging");
  static_assert(kColsPerThread * kThreads == 2 * kChunk, "bases staging");
};

static_assert(Tile<4>::kFrames == kSmallTile, "small tile");

// Loads one pipeline stage (samples k0..k0+kKC-1) into registers: sample xk
// of this thread's staged frames, and its bases columns.
template <int kXs, int kCols>
__device__ __forceinline__ void prefetch(float* x_pre, float (*b_pre)[kKC],
                                         const float* const* xsrc,
                                         const bool* xok, int xk,
                                         const float* const* bsrc,
                                         const bool* bok, int k0, int n_fft,
                                         int n_bins) {
#pragma unroll
  for (int p = 0; p < kXs; ++p) {
    const int k = k0 + xk;
    x_pre[p] = (xok[p] && k < n_fft) ? __ldg(xsrc[p] + k) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q)
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const int k = k0 + kk;
      b_pre[q][kk] = (bok[q] && k < n_fft)
                         ? __ldg(bsrc[q] + static_cast<long long>(k) * n_bins)
                         : 0.f;
    }
}

template <int kFpw>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ wav, const float* __restrict__ cos_b,
              const float* __restrict__ sin_b, const float* __restrict__ mel,
              float* __restrict__ out, float* __restrict__ partial,
              int* __restrict__ done, int n_rows, int n_frames,
              long long row_stride, int hop, int n_fft, int n_bins,
              int n_used, int n_mels, int magnitude, float log_eps) {
  using T = Tile<kFpw>;
  __shared__ __align__(16) float xs[kKC][T::kXsStride];  // samples x frames
  __shared__ __align__(16) float bs[kKC][2 * kChunk];    // cos | sin
  __shared__ __align__(16) float ps[T::kFrames][kPsStride];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * T::kFrames;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int bin0 = chunk * kChunk;

  // What this thread stages each step: sample xk of frames xf[p], and the
  // kKC samples of bases columns tid + q * kThreads (cos below kChunk).
  const int xk = tid % kKC;
  int xf[T::kXsPerThread];
  const float* xsrc[T::kXsPerThread];
  bool xok[T::kXsPerThread];
#pragma unroll
  for (int p = 0; p < T::kXsPerThread; ++p) {
    xf[p] = tid / kKC + p * (kThreads / kKC);
    const int r = row0 + xf[p];
    xok[p] = r < n_rows;
    const int b = xok[p] ? r / n_frames : 0;
    const int i = xok[p] ? r - b * n_frames : 0;
    xsrc[p] = wav + b * row_stride + static_cast<long long>(i) * hop;
  }
  const float* bsrc[T::kColsPerThread];
  bool bok[T::kColsPerThread];
#pragma unroll
  for (int q = 0; q < T::kColsPerThread; ++q) {
    const int j = tid + q * kThreads;
    const int bin = bin0 + j % kChunk;
    bok[q] = bin < n_used;
    bsrc[q] = (j < kChunk ? cos_b : sin_b) + (bok[q] ? bin : 0);
  }

  float x_pre[T::kXsPerThread];
  float b_pre[T::kColsPerThread][kKC];
  float re[kFpw][kBinsPerLane];
  float im[kFpw][kBinsPerLane];
#pragma unroll
  for (int f = 0; f < kFpw; ++f)
#pragma unroll
    for (int q = 0; q < kBinsPerLane; ++q) re[f][q] = im[f][q] = 0.f;

  prefetch<T::kXsPerThread, T::kColsPerThread>(x_pre, b_pre, xsrc, xok, xk,
                                               bsrc, bok, 0, n_fft, n_bins);
  for (int k0 = 0; k0 < n_fft; k0 += kKC) {
#pragma unroll
    for (int p = 0; p < T::kXsPerThread; ++p) xs[xk][xf[p]] = x_pre[p];
#pragma unroll
    for (int q = 0; q < T::kColsPerThread; ++q)
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk)
        bs[kk][tid + q * kThreads] = b_pre[q][kk];
    __syncthreads();
    if (k0 + kKC < n_fft)
      prefetch<T::kXsPerThread, T::kColsPerThread>(
          x_pre, b_pre, xsrc, xok, xk, bsrc, bok, k0 + kKC, n_fft, n_bins);

#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float x[kFpw];
#pragma unroll
      for (int h = 0; h < kFpw / 4; ++h) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &xs[kk][warp * kFpw + 4 * h]);
        x[4 * h] = xv.x;
        x[4 * h + 1] = xv.y;
        x[4 * h + 2] = xv.z;
        x[4 * h + 3] = xv.w;
      }
      const float4 cv =
          *reinterpret_cast<const float4*>(&bs[kk][lane * kBinsPerLane]);
      const float4 sv = *reinterpret_cast<const float4*>(
          &bs[kk][kChunk + lane * kBinsPerLane]);
      const float cc[kBinsPerLane] = {cv.x, cv.y, cv.z, cv.w};
      const float ss[kBinsPerLane] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int f = 0; f < kFpw; ++f)
#pragma unroll
        for (int q = 0; q < kBinsPerLane; ++q) {
          re[f][q] = fmaf(x[f], cc[q], re[f][q]);
          im[f][q] = fmaf(x[f], ss[q], im[f][q]);
        }
    }
    __syncthreads();
  }

  // Power of this chunk -> shared memory (bins past n_used are 0 here).
#pragma unroll
  for (int f = 0; f < kFpw; ++f) {
    float pw[kBinsPerLane];
#pragma unroll
    for (int q = 0; q < kBinsPerLane; ++q) {
      const float v = re[f][q] * re[f][q] + im[f][q] * im[f][q];
      pw[q] = magnitude ? sqrtf(v) : v;
    }
    *reinterpret_cast<float4*>(
        &ps[warp * kFpw + f][lane * kBinsPerLane]) =
        make_float4(pw[0], pw[1], pw[2], pw[3]);
  }
  __syncthreads();

  // This chunk's share of the mel product: lane owns mels lane + 32 j.
  float acc[kFpw][kMelsPerLane];
#pragma unroll
  for (int f = 0; f < kFpw; ++f)
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) acc[f][j] = 0.f;
  const int nb = min(kChunk, n_used - bin0);
  for (int bb = 0; bb < nb; ++bb) {
    const float* mrow = mel + static_cast<long long>(bin0 + bb) * n_mels;
    float mv[kMelsPerLane];
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) {
      const int m = lane + 32 * j;
      mv[j] = m < n_mels ? __ldg(mrow + m) : 0.f;
    }
#pragma unroll
    for (int f = 0; f < kFpw; ++f) {
      const float pv = ps[warp * kFpw + f][bb];
#pragma unroll
      for (int j = 0; j < kMelsPerLane; ++j)
        acc[f][j] = fmaf(pv, mv[j], acc[f][j]);
    }
  }
#pragma unroll
  for (int f = 0; f < kFpw; ++f) {
    const int r = row0 + warp * kFpw + f;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels)
        partial[(static_cast<long long>(chunk) * n_rows + r) * n_mels + m] =
            acc[f][j];
    }
  }

  // The last block of this frame tile adds the chunks' partials in chunk
  // order (deterministic) and applies the log.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done + blockIdx.x, 1) == n_chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int f = 0; f < kFpw; ++f) {
    const int r = row0 + warp * kFpw + f;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) {
      const int m = lane + 32 * j;
      if (m >= n_mels) continue;
      float sum = 0.f;
      for (int c = 0; c < n_chunks; ++c)
        sum += __ldcg(partial +
                      (static_cast<long long>(c) * n_rows + r) * n_mels + m);
      out[static_cast<long long>(r) * n_mels + m] = logf(log_eps + sum);
    }
  }
}

int n_chunks_for(int n_used) { return (n_used + kChunk - 1) / kChunk; }

long long n_small_tiles(int batch, int n_frames) {
  return (static_cast<long long>(batch) * n_frames + kSmallTile - 1) /
         kSmallTile;
}

}  // namespace

extern "C" {

// Size in 4-byte words of the workspace logmel_forward needs: the chunks'
// partial mel sums, then one counter per frame tile.
long long logmel_workspace_words(int batch, int n_frames, int n_used,
                                 int n_mels) {
  return static_cast<long long>(n_chunks_for(n_used)) * batch * n_frames *
             n_mels +
         n_small_tiles(batch, n_frames);
}

// wav [batch, length] fp32 (already padded), cos_b / sin_b [n_fft, n_bins],
// mel [n_bins, n_mels] with n_mels <= 128, out [batch, n_frames, n_mels],
// workspace of logmel_workspace_words(...) words. Computes frames
// 0..n_frames-1 of every clip, frame i starting at sample i*hop; bins
// n_used..n_bins-1 must have all-zero mel rows. Clears the tile counters
// and launches the kernel on `stream`, without synchronising; returns
// cudaGetLastError() (0 on success).
int logmel_forward(const float* wav, const float* cos_b, const float* sin_b,
                   const float* mel, float* out, void* workspace, int batch,
                   long long length, int n_frames, int hop, int n_fft,
                   int n_bins, int n_used, int n_mels, int magnitude,
                   float log_eps, void* stream) {
  if (batch < 1 || n_frames < 1 || hop < 1 || n_fft < 1 || n_mels < 1 ||
      n_mels > kMaxMels || n_used < 1 || n_used > n_bins ||
      static_cast<long long>(n_frames - 1) * hop + n_fft > length ||
      static_cast<long long>(batch) * n_frames > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = batch * n_frames;
  const int n_chunks = n_chunks_for(n_used);
  float* partial = static_cast<float*>(workspace);
  int* done = reinterpret_cast<int*>(
      partial + static_cast<long long>(n_chunks) * n_rows * n_mels);
  const long long small_tiles = n_small_tiles(batch, n_frames);
  cudaError_t err = cudaMemsetAsync(done, 0, small_tiles * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int wide_tiles = (n_rows + Tile<8>::kFrames - 1) / Tile<8>::kFrames;
  if (static_cast<long long>(wide_tiles) * n_chunks >= 2LL * n_sm) {
    logmel_kernel<8><<<dim3(wide_tiles, n_chunks), kThreads, 0, s>>>(
        wav, cos_b, sin_b, mel, out, partial, done, n_rows, n_frames, length,
        hop, n_fft, n_bins, n_used, n_mels, magnitude, log_eps);
  } else {
    logmel_kernel<4><<<dim3(static_cast<unsigned>(small_tiles), n_chunks),
                       kThreads, 0, s>>>(
        wav, cos_b, sin_b, mel, out, partial, done, n_rows, n_frames, length,
        hop, n_fft, n_bins, n_used, n_mels, magnitude, log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
