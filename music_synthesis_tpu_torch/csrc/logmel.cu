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
// 2 * 1024 * 1024 ~ 2.1 MFLOP per frame (bins 0..511) against 1 KB of new
// input per frame (hop 256), far above the card's ridge point, and it is
// ~94% of the operations. In fp32 FFMA (67 TFLOP/s) it takes at least
// ~17 us for 512 frames and ~183 us for 5,504. On the tensor cores an
// fp32-accurate product takes three TF32 passes (495 TFLOP/s dense): at
// least ~7 us and ~75 us.
//
// Two paths, one per precision mode of the wrapper (ops/logmel.py):
//
// "fast": the rDFT on the tensor cores, 3xTF32 (tc::logmel_wgmma_kernel).
// - Each operand x is split into TF32 parts hi (its top 10 mantissa bits)
//   and lo = x - hi, and lo*hi + hi*lo + hi*hi is summed in fp32 (lo*lo,
//   ~2^-22 relative, is dropped): fp32-level accuracy at three tensor-core
//   passes. The bases are split once on the host (ops/logmel.py,
//   split_bases) and stored K-major, [chunk][hi | lo][cos | sin][bin]
//   [sample]: the cos and sin rows of a chunk's 64 bins are one N = 128
//   operand of wgmma.mma_async.m64n128k8, read from shared memory through
//   a descriptor. The frames are split in registers.
// - A block is 64 frames x one 64-bin chunk, 256 threads: one warpgroup of
//   consumers issues the wgmmas (A, the frames, from registers; B hi and
//   B lo from shared memory), one warpgroup of producers feeds a 4-stage
//   ring of 32 samples per stage (one 128-byte swizzle row of TF32): B by
//   two TMA loads per stage from one thread, the frames by 4-byte cp.async
//   from all 128 (each frame read in place, so a tile may cross a clip and
//   rows need not be aligned), written in the same 128-byte swizzle so
//   that the consumers' fragment loads are conflict-free. Full and empty
//   mbarriers order the ring; a stage's wgmmas are issued before the
//   previous stage's have finished (wgmma.wait_group 1).
// - The samples are walked in 4 phases, k = 4 j + phase (the bases store
//   them in that order, so a stage holds 32 samples 4 apart). The tensor
//   cores sum each phase from zero, and the phases' sums are added in fp32
//   on the CUDA cores, in shared memory: the tensor cores' accumulation
//   alone loses accuracy in near-silent bins (at logmel_wgmma_kernel).
// - The K walk of a tile can be split across a cluster of 2 or 4 blocks,
//   each taking the phases k = rank mod split. The others' re and im reach
//   the first block through distributed shared memory, added in rank
//   order before squaring, so the result does not depend on timing. The
//   launcher picks the split from the SM count, the card's resident
//   clusters and one table of the card's times (logmel_forward).
// - The bases are the large stream (32 KB a stage against 8 KB of
//   frames); at n_fft 1024 all of them take 8.4 MB and stay in L2. On an
//   H100 neither halving them nor cutting the products to a third moved a
//   stage's time much: the walk is bound by the ring's latency, and the
//   mel epilogue and the launch are a large share of a small call.
//
// "exact": fp32 FFMA (ffma::logmel_ffma_kernel). It accumulates in the
// order of the plain version's cuBLAS fp32 GEMM and agrees with it to ~1e-6
// in the log domain; the 3xTF32 path, rounded elsewhere, lands further
// from it in near-silent mel bins than the "exact" gate of 2e-4 allows. A
// thread keeps an 8-frame (4 on small grids) x 4-bin register tile of re
// and im over 128-bin chunks, the next stage prefetched into registers.
//
// Both paths end in the same epilogue (mel_epilogue): the power tile in
// shared memory -> the block's bin chunk of the mel product in fp32 FFMA,
// for the 32-mel groups that chunk feeds (any n_mels) -> partial sums in a
// workspace -> the last block of each frame tile to finish (a counter per
// tile) adds the partials in chunk order and applies the log, so the
// result is deterministic. Only bins up to the last one with a non-zero
// mel weight are computed (bin 512 of a 1024-point DFT has none).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// and called through ctypes (music_synthesis_tpu_torch/_build.py). The TMA
// descriptor encoder comes from libcuda through cudaGetDriverEntryPoint,
// so the library links only the CUDA runtime.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kSmallTile = 16;                 // fewest frames per block
constexpr int kWsChunk = 64;                   // fewest bins per block

// The 32-mel groups [lo, hi] with a non-zero weight in the bins of chunk
// `chunk` (chunk_bins bins), from `groups`: the first and last such group of
// each 64-bin chunk (ops/logmel.py, mel_groups). lo > hi if none.
__device__ __forceinline__ int2 chunk_groups(const int* __restrict__ groups,
                                             int chunk, int chunk_bins,
                                             int n_used) {
  const int per = chunk_bins / kWsChunk;
  int2 g = make_int2(1 << 30, -1);
  for (int i = 0; i < per; ++i) {
    const int c64 = chunk * per + i;
    if (c64 * kWsChunk >= n_used) break;
    g.x = min(g.x, __ldg(groups + 2 * c64));
    g.y = max(g.y, __ldg(groups + 2 * c64 + 1));
  }
  return g;
}

// The epilogue both paths share. ps holds this block's power tile: kFpw
// frames per warp (from row0) x chunk_bins bins (from bin0), row stride
// ps_stride (a multiple of 4; bins past n_used hold 0); smel has room for
// chunk_bins x 32 floats. Mel filters are narrow, so a chunk of bins feeds
// only a few 32-mel groups: for each of those, the block stages the
// group's weights of its bins in smel, and lane l of warp w sums mel
// 32 group + l of frames w kFpw.. over the chunk's bins in order (fp32
// FFMA) into the chunk's partial plane. The last block of the frame tile to
// finish adds, for every output, the partials of the chunks that feed it in
// chunk order, and writes log(eps + sum). Skipping a group only skips
// adding exact zeros.
template <int kFpw, int kThreadsT>
__device__ __forceinline__ void mel_epilogue(
    const float* ps, int ps_stride, int chunk_bins, float* smel,
    const float* __restrict__ mel, const int* __restrict__ groups,
    float* __restrict__ out, float* __restrict__ partial,
    int* __restrict__ done, bool* s_last, int chunk, int n_chunks, int row0,
    int n_rows, int bin0, int n_used, int n_mels, float log_eps) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nb = min(chunk_bins, n_used - bin0);
  const int nb4 = (nb + 3) & ~3;
  const long long plane = static_cast<long long>(n_rows) * n_mels;
  const int2 mine = chunk_groups(groups, chunk, chunk_bins, n_used);
  for (int gm = mine.x; gm <= mine.y; ++gm) {
    const int m = 32 * gm + lane;
    __syncthreads();  // the previous group's weights are consumed
    for (int i = tid; i < nb4 * 32; i += kThreadsT) {
      const int bb = i >> 5;
      const int mm = 32 * gm + (i & 31);
      smel[i] = bb < nb && mm < n_mels
                    ? __ldg(mel + static_cast<long long>(bin0 + bb) * n_mels +
                            mm)
                    : 0.f;
    }
    __syncthreads();
    float acc[kFpw];
#pragma unroll
    for (int f = 0; f < kFpw; ++f) acc[f] = 0.f;
#pragma unroll 2
    for (int bb = 0; bb < nb; bb += 4) {
      float mv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) mv[u] = smel[(bb + u) * 32 + lane];
#pragma unroll
      for (int f = 0; f < kFpw; ++f) {
        const float4 p = *reinterpret_cast<const float4*>(
            ps + (warp * kFpw + f) * ps_stride + bb);
        acc[f] = fmaf(p.x, mv[0], acc[f]);
        acc[f] = fmaf(p.y, mv[1], acc[f]);
        acc[f] = fmaf(p.z, mv[2], acc[f]);
        acc[f] = fmaf(p.w, mv[3], acc[f]);
      }
    }
    if (m < n_mels) {
#pragma unroll
      for (int f = 0; f < kFpw; ++f) {
        const int r = row0 + warp * kFpw + f;
        if (r < n_rows)
          partial[chunk * plane + static_cast<long long>(r) * n_mels + m] =
              acc[f];
      }
    }
  }

  __threadfence();
  __syncthreads();
  // The tile's index from row0 (live here anyway), not a register kept
  // across the main loop.
  constexpr int kRows = kFpw * (kThreadsT / 32);
  if (tid == 0) *s_last = atomicAdd(done + row0 / kRows, 1) == n_chunks - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // Every chunk's group range, into shared memory (smel is free now).
  int2* sg = reinterpret_cast<int2*>(smel);
  for (int c = tid; c < n_chunks; c += kThreadsT)
    sg[c] = chunk_groups(groups, c, chunk_bins, n_used);
  __syncthreads();
  // This tile's outputs, spread over the block's threads (16-byte words
  // where the mel count allows), each summed over the chunks in order.
  const int rows = min(kRows, n_rows - row0);
  const long long base = static_cast<long long>(row0) * n_mels;
  if (n_mels % 4 == 0) {
    const int n4 = rows * n_mels / 4;
    const float4* src = reinterpret_cast<const float4*>(partial + base);
    float4* dst = reinterpret_cast<float4*>(out + base);
    for (int q = tid; q < n4; q += kThreadsT) {
      const int gm = (q % (n_mels / 4)) / 8;  // the quad's 32-mel group
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < n_chunks; ++c) {
        const int2 gc = sg[c];
        if (gm < gc.x || gm > gc.y) continue;
        const float4 v = __ldcg(src + c * plane / 4 + q);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      dst[q] = make_float4(logf(log_eps + sum.x), logf(log_eps + sum.y),
                           logf(log_eps + sum.z), logf(log_eps + sum.w));
    }
  } else {
    const int n1 = rows * n_mels;
    for (int q = tid; q < n1; q += kThreadsT) {
      const int gm = (q % n_mels) / 32;
      float sum = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        const int2 gc = sg[c];
        if (gm < gc.x || gm > gc.y) continue;
        sum += __ldcg(partial + base + c * plane + q);
      }
      out[base + q] = logf(log_eps + sum);
    }
  }
}

// ---------------------------------------------------------------------------
// "exact": fp32 FFMA.
namespace ffma {

constexpr int kBinsPerLane = 4;                // a thread's bin columns
constexpr int kChunk = 32 * kBinsPerLane;      // 128 bins per block
constexpr int kKC = 8;                         // samples per pipeline stage
constexpr int kPsStride = kChunk + 4;          // keeps rows 16-byte aligned
constexpr int kWarps = 4;                      // warps per block
constexpr int kThreads = 32 * kWarps;

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
__global__ void __launch_bounds__(kThreads, 1)
logmel_ffma_kernel(const float* __restrict__ wav,
                   const float* __restrict__ cos_b,
                   const float* __restrict__ sin_b,
                   const float* __restrict__ mel,
                   const int* __restrict__ groups, float* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ done,
                   int n_rows, int n_frames, long long row_stride, int hop,
                   int n_fft, int n_bins, int n_used, int n_mels,
                   int magnitude, float log_eps, int n_chunks) {
  using T = Tile<kFpw>;
  __shared__ __align__(16) float xs[kKC][T::kXsStride];  // samples x frames
  __shared__ __align__(16) float bs[kKC][2 * kChunk];    // cos | sin
  __shared__ __align__(16) float ps[T::kFrames][kPsStride];
  __shared__ __align__(16) float smel[kChunk * 32];  // a mel group's weights
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = blockIdx.x % n_chunks;  // chunks of a tile run together
  const int row0 = blockIdx.x / n_chunks * T::kFrames;
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
  mel_epilogue<kFpw, kThreads>(&ps[0][0], kPsStride, kChunk, smel, mel, groups,
                               out,
                               partial, done, &s_last, chunk, n_chunks, row0,
                               n_rows, bin0, n_used, n_mels, log_eps);
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// "fast": 3xTF32 on the tensor cores (wgmma), fed by a TMA ring.
namespace tc {

namespace cg = cooperative_groups;

constexpr int kBM = 64;                    // frames per block (wgmma's M)
constexpr int kBN = kWsChunk;              // bins per block, each of cos, sin
constexpr int kN = 2 * kBN;                // wgmma's N: cos | sin
constexpr int kBK = 32;                    // samples per stage: 128 bytes
constexpr int kStages = 4;                 // ring depth
constexpr int kPhases = 4;                 // the bases' sample phases (mod 4)
constexpr int kConsumers = 128;            // one warpgroup issues the wgmmas
constexpr int kThreads = 2 * kConsumers;   // one feeds the ring
constexpr int kAcc = kN / 2;               // accumulators per consumer thread
constexpr int kBTile = kN * kBK * 4;       // bytes of B hi (or B lo), 16 KB
constexpr int kATile = kBM * kBK * 4;      // bytes of the frames, 8 KB
constexpr int kStageBytes = 2 * kBTile + kATile;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSumBytes = 4 * kAcc * kConsumers;  // the phases' sums
constexpr int kSmemBytes = kRingBytes + kSumBytes + 1024;  // + alignment
constexpr int kPsStride = kBN + 8;         // conflict-free float2 power stores
constexpr int kFpw = kBM / (kThreads / 32);  // mel-stage frames per warp
static_assert(kBK * 4 == 128, "a stage's rows are one 128-byte swizzle row");
static_assert(kBTile % 1024 == 0 && kStageBytes % 1024 == 0,
              "swizzle atoms stay 1024-byte aligned");
static_assert(4 * (kBM * kPsStride + 32 * kBN) <= kRingBytes,
              "epilogue in the ring");
static_assert(kFpw * (kThreads / 32) == kBM, "mel-stage frames");

// x = hi + lo + O(2^-21 |x|) in TF32 operands: hi keeps the top 10
// mantissa bits of x, lo = x - hi is exact in fp32 and the tensor cores
// read its top 10 (two instructions, no cvt).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts 2^28 tries (seconds) is a fault of the ring's protocol: it traps,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` from the TMA loads of the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One arrival once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :
               : "r"(smem_addr(bar))
               : "memory");
}

// Copies `bytes` (0 or 4) bytes and zero-fills the rest of the 4.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

// The box at (c0, c1) of a 2-D tensor map into shared memory, counted on
// `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma's descriptor of a K-major tile as TMA writes it with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (the start
// 1024-byte aligned; +2 per k8 step moves it 32 bytes along K).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return ((smem_addr(tile) & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = a (64 x 8, TF32, registers) * b (8 x 128, TF32,
// the K-major tile of `desc`) + d if `add`, else + 0. a0..a3 of warp w:
// (16 w + g, t), (16 w + g + 8, t), (16 w + g, t + 4), (16 w + g + 8,
// t + 4).
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc, int add = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}
// Stage i of a consumer's walk, A fragments into register buffer kBuf:
// its frames from the swizzled tile (rows r0 / kBK and + 8; 16-byte chunks
// 2 kk and 2 kk + 1 at chunk ^ g), split into hi and lo in a buffer of
// their own (the stage's wgmmas read it until the next stage has waited
// for them), then 3 wgmmas per k8, the first of a phase (`fresh`) not
// adding acc; then it releases stage i - 1's slot.
template <int kBuf>
__device__ __forceinline__ void consume(float (&acc)[kAcc],
                                        uint32_t (&ah)[2][kBK / 8][4],
                                        uint32_t (&al)[2][kBK / 8][4],
                                        const uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int i, bool fresh,
                                        int r0, int g, int t, int lane) {
  const int slot = i % kStages;
  mbar_wait(&full[slot], (i / kStages) & 1);
  __syncwarp();
  const uint8_t* st = ring + slot * kStageBytes;
  const float* sa = reinterpret_cast<const float*>(st + 2 * kBTile);
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const int c0 = 4 * ((2 * kk) ^ g) + t;
    const int c1 = 4 * ((2 * kk + 1) ^ g) + t;
    const float v[4] = {sa[r0 + c0], sa[r0 + 8 * kBK + c0], sa[r0 + c1],
                        sa[r0 + 8 * kBK + c1]};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_tf32(v[q], ah[kBuf][kk][q], al[kBuf][kk][q]);
  }
  const uint64_t d_hi = sw128_desc(st);
  const uint64_t d_lo = sw128_desc(st + kBTile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    // lo*hi and hi*lo first, the large hi*hi last.
    wgmma_tf32(acc, al[kBuf][kk], d_hi + 2 * kk, !fresh || kk > 0);
    wgmma_tf32(acc, ah[kBuf][kk], d_lo + 2 * kk);
    wgmma_tf32(acc, ah[kBuf][kk], d_hi + 2 * kk);
  }
  wgmma_commit();
  wgmma_wait<1>();  // the previous stage's products are done
  if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
}

// sum += part once the tensor cores have finished it (fp32, rounding to
// nearest). sum: this thread's accumulators in shared memory, kConsumers
// apart.
__device__ __forceinline__ void add_phase(float* sum, float (&part)[kAcc]) {
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int a = 0; a < kAcc; ++a) sum[a * kConsumers] += part[a];
}

// A block of kThreads threads computes frames row0.. row0 + kBM - 1 x the
// 64 bins of `chunk`, walking the bases' sample phases in order: the
// samples k = 4 j + phase, phase 0 first (ops/logmel.py, split_bases).
// The tensor cores sum each phase from zero, and the phases' sums are
// added in fp32 on the CUDA cores. With a split, the cluster's blocks
// share the walk: rank r takes phases r, r + split, ... (the samples
// k = r mod split) and hands its sums to rank 0, which runs the epilogue.
// Why phases: the tensor cores' fp32 accumulation loses accuracy where a
// near-silent bin's partial sums are large and cancel, as they do over a
// window cut short (a contiguous share of the walk ends at the Hann
// window's peak). A phase is a decimated window: a bin's sum over it is
// about a quarter of the bin's own plus aliases from bins n_fft / 4 away
// (high and quiet in audio). On an H100 a contiguous split was several
// times further from the float64 answer than one walk in natural order,
// and so was one accumulator over all four phases; each phase from zero is
// closer than either, whatever the split (chip_smoke.py phase 2 prints
// each split's error).
//
// bases: the tensor map of the split bases ([n_chunks][hi | lo][cos | sin]
// [64 bins] rows of k_stages * kBK samples in phase order, zero past n_fft
// and n_used), box kBK samples x kN rows, 128-byte swizzle.
__global__ void __launch_bounds__(kThreads, 1)
logmel_wgmma_kernel(const __grid_constant__ CUtensorMap bases,
                    const float* __restrict__ wav,
                    const float* __restrict__ mel,
                    const int* __restrict__ groups, float* __restrict__ out,
                    float* __restrict__ partial, int* __restrict__ done,
                    int n_rows, int n_frames, long long row_stride, int hop,
                    int n_fft, int k_stages, int n_chunks, int n_used,
                    int n_mels, int magnitude, float log_eps, int split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ bool s_last;
  uint8_t* ring = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  float* sums = reinterpret_cast<float*>(ring + kRingBytes);

  const int tid = threadIdx.x;
  const int rank =
      split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int unit = blockIdx.x / split;  // a cluster: one tile, one chunk
  const int chunk = unit % n_chunks;    // chunks of a tile run together
  const int row0 = unit / n_chunks * kBM;
  const int bin0 = chunk * kBN;
  const int per_phase = k_stages / kPhases;     // stages of one phase
  const int n_walk = kPhases / split * per_phase;  // this block's stages

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kConsumers + 1);    // cp.async arrivals + TMA's
      mbar_init(&empty[i], kConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producers. Thread p copies sample column p % 32 of frame rows
    // p / 32 + 4 q of each stage, read in place (nullptr past the last
    // row), 4 bytes each (a stage's samples are 4 apart), into TMA's
    // 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8).
    const int p = tid - kConsumers;
    const int col = p % 32;
    const float* src[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int r = row0 + p / 32 + 4 * q;
      const int b = r / n_frames;
      src[q] = r >= n_rows ? nullptr
                           : wav + b * row_stride +
                                 static_cast<long long>(r - b * n_frames) * hop;
    }
    for (int i = 0; i < n_walk; ++i) {
      const int slot = i % kStages;
      if (i >= kStages) mbar_wait(&empty[slot], (i / kStages - 1) & 1);
      uint8_t* st = ring + slot * kStageBytes;
      float* sa = reinterpret_cast<float*>(st + 2 * kBTile);
      // Stage j of phase `phase`: bases columns (phase per_phase + j) kBK..,
      // samples k = kPhases (j kBK + column) + phase.
      const int phase = rank + split * (i / per_phase);
      const int j = i % per_phase;
      const int k = kPhases * (j * kBK + col) + phase;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = p / 32 + 4 * q;
        const bool ok = src[q] && k < n_fft;
        cp_async4(sa + r * kBK + 4 * ((col / 4) ^ (r % 8)) + col % 4,
                  ok ? src[q] + k : wav, ok ? 4 : 0);
      }
      cp_async_arrive(&full[slot]);
      if (p == 0) {
        const int k0 = (phase * per_phase + j) * kBK;
        mbar_expect_tx(&full[slot], 2 * kBTile);
        tma_load_2d(st, &bases, k0, 2 * chunk * kN, &full[slot]);
        tma_load_2d(st + kBTile, &bases, k0, (2 * chunk + 1) * kN,
                    &full[slot]);
      }
    }
  } else {
    // Consumers: warp w owns frames 16 w .. 16 w + 15 of the tile; the
    // stages alternate between two buffers of A fragments.
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = (16 * warp + g) * kBK;
    uint32_t ah[2][kBK / 8][4], al[2][kBK / 8][4];  // [buffer][k8][fragment]
    // Each phase is summed from zero by the tensor cores into `part`, which
    // is then added into this thread's sums.
    float* sum = sums + tid;
    float part[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      sum[a * kConsumers] = 0.f;
      part[a] = 0.f;
    }
    fence_acc(part);
    for (int i0 = 0; i0 < n_walk; i0 += per_phase) {
      for (int j = 0; j < per_phase; j += 2) {
        consume<0>(part, ah, al, ring, full, empty, i0 + j, j == 0, r0, g, t,
                   lane);
        if (j + 1 < per_phase)
          consume<1>(part, ah, al, ring, full, empty, i0 + j + 1, false, r0,
                     g, t, lane);
      }
      add_phase(sum, part);
    }
  }
  __syncthreads();  // the ring is drained: its memory is free

  float* ps = reinterpret_cast<float*>(ring);
  float acc[kAcc];  // re and im of the consumer thread's fragment
  if (tid < kConsumers) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = sums[i * kConsumers + tid];
  }
  if (split > 1) {
    // The other ranks' re and im, added into rank 0's in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's sums are final
    if (rank == 0 && tid < kConsumers) {
      for (int q = 1; q < split; ++q) {
        const float* other = cluster.map_shared_rank(sums, q);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += other[i * kConsumers + tid];
      }
    }
    cluster.sync();  // rank 0 has read the others' shared memory
    if (rank > 0) return;
  }

  if (tid < kConsumers) {
    // Accumulator i of thread (warp, g, t): frame 16 warp + g + 8 (i / 2 %
    // 2), column 8 (i / 4) + 2 t + i % 2; cos in columns 0..63, sin in
    // 64..127 (n8 tile j + 8 of bin tile j).
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float pw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float re = acc[4 * j + q];
        const float im = acc[4 * (j + kBN / 8) + q];
        const float v = re * re + im * im;
        pw[q] = magnitude ? sqrtf(v) : v;
      }
      const int r = 16 * warp + g;
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(ps + r * kPsStride + col) =
          make_float2(pw[0], pw[1]);
      *reinterpret_cast<float2*>(ps + (r + 8) * kPsStride + col) =
          make_float2(pw[2], pw[3]);
    }
  }
  __syncthreads();
  mel_epilogue<kFpw, kThreads>(ps, kPsStride, kBN, ps + kBM * kPsStride, mel,
                               groups, out, partial, done, &s_last, chunk,
                               n_chunks, row0, n_rows, bin0, n_used, n_mels,
                               log_eps);
}

// What the host sets up once per device: the kernel's shared memory, the
// SM count and how many clusters of each split fit on the card at once.
struct Device {
  bool ready = false;
  int n_sm = 0;
  int resident[3] = {0, 0, 0};  // split 1, 2, 4
};

cudaError_t setup(int device, Device& d) {
  cudaError_t err = cudaFuncSetAttribute(
      logmel_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << i;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1u << i);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&d.resident[i], logmel_wgmma_kernel,
                                         &cfg);
  }
  d.ready = err == cudaSuccess;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr.
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

// The tensor map of one device's split bases, by (device, pointer).
struct BasesMap {
  int device;
  const void* ptr;
  int k_stages;
  int rows;
  CUtensorMap map;
};

// Errors of the host set-up that are not CUDA's: kEncodeMissing when
// libcuda has no cuTensorMapEncodeTiled, kEncodeFailed + its CUresult when
// it refuses the bases' map.
constexpr int kEncodeMissing = 10000;
constexpr int kEncodeFailed = 10001;

int bases_map(int device, const float* ptr, int k_stages, int rows,
              CUtensorMap* map) {
  static std::mutex mu;
  static std::vector<BasesMap> maps;
  static EncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  for (const BasesMap& m : maps) {
    if (m.device == device && m.ptr == ptr && m.k_stages == k_stages &&
        m.rows == rows) {
      *map = m.map;
      return 0;
    }
  }
  if (encode == nullptr) encode = encode_tiled();
  if (encode == nullptr) return kEncodeMissing;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_stages) * kBK,
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {dims[0] * 4};
  const cuuint32_t box[2] = {kBK, kN};
  const cuuint32_t steps[2] = {1, 1};
  BasesMap m{device, ptr, k_stages, rows, {}};
  const CUresult r = encode(
      &m.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  maps.push_back(m);
  *map = m.map;
  return 0;
}

// The split's time per block, in stages of the K walk: each block also
// pays a fixed cost (the ring's fill, the cluster's reduction, the mel
// epilogue), from chip_smoke.py's times of each forced split on an H100
// (PERF.md).
constexpr int kSplits[3] = {1, 2, 4};
constexpr double kFixedStages[3] = {4.0, 12.0, 18.0};

// The split for `units` (frame tile, chunk) pairs: the one whose busiest
// cluster slot takes the least time, ceil(units / resident clusters) x
// (stages per block + the fixed cost); `forced` (1, 2 or 4) takes that one.
// -1 if none fits.
int pick_split(const Device& d, long long units, int k_stages, int forced) {
  int pick = -1;
  double best = 0.0;
  for (int i = 0; i < 3; ++i) {
    const int split = kSplits[i];
    if (d.resident[i] < 1) continue;
    if (forced != 0) {
      if (forced == split) return split;
      continue;
    }
    const long long waves = (units + d.resident[i] - 1) / d.resident[i];
    const double cost = static_cast<double>(waves) *
                        ((k_stages + split - 1) / split + kFixedStages[i]);
    if (pick < 0 || cost < best) best = cost, pick = split;
  }
  return pick;
}

}  // namespace tc

int n_chunks_for(int n_used) { return (n_used + kWsChunk - 1) / kWsChunk; }

long long n_small_tiles(int batch, int n_frames) {
  return (static_cast<long long>(batch) * n_frames + kSmallTile - 1) /
         kSmallTile;
}

constexpr int kMaxDevices = 64;

// The current device and its set-up (made at its first use).
cudaError_t current_device(int* device, tc::Device* dev) {
  static std::mutex mu;
  static tc::Device devices[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!devices[*device].ready) {
    err = tc::setup(*device, devices[*device]);
    if (err != cudaSuccess) return err;
  }
  *dev = devices[*device];
  return cudaSuccess;
}

// The "fast" path's stages over n_fft samples: whole stages per phase.
int fast_stages(int n_fft) {
  constexpr int kSamples = tc::kBK * tc::kPhases;
  return (n_fft + kSamples - 1) / kSamples * tc::kPhases;
}

long long n_fast_units(int batch, int n_frames, int n_used) {
  return (static_cast<long long>(batch) * n_frames + tc::kBM - 1) / tc::kBM *
         n_chunks_for(n_used);
}

}  // namespace

extern "C" {

// Size in 4-byte words of the workspace logmel_forward needs: the chunks'
// partial mel sums (64-bin chunks, the most of either path), then one
// counter per 16-frame tile.
long long logmel_workspace_words(int batch, int n_frames, int n_used,
                                 int n_mels) {
  return static_cast<long long>(n_chunks_for(n_used)) * batch * n_frames *
             n_mels +
         n_small_tiles(batch, n_frames);
}

// The K split the "fast" path's launcher picks on the current device for
// this shape (1, 2 or 4), or -(CUDA error) (-cudaErrorInvalidConfiguration
// when none fits).
int logmel_fast_split(int batch, int n_frames, int n_fft, int n_used) {
  int device = 0;
  tc::Device dev;
  const cudaError_t err = current_device(&device, &dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int pick =
      tc::pick_split(dev, n_fast_units(batch, n_frames, n_used),
                     fast_stages(n_fft), 0);
  return pick > 0 ? pick : -static_cast<int>(cudaErrorInvalidConfiguration);
}

// wav [batch, length] fp32 (already padded), mel [n_bins, n_mels] (any
// n_mels >= 1), groups [ceil(n_used / 64), 2] (the first and last 32-mel
// group with a non-zero weight in each 64-bin chunk), out [batch, n_frames,
// n_mels], workspace of logmel_workspace_words(...) words. tensor_cores = 0
// ("exact") reads the fp32 bases cos_b / sin_b [n_fft, n_bins];
// tensor_cores = 1 ("fast") reads the same bases split into TF32 hi and
// lo, `split_b` (layout at tc::logmel_wgmma_kernel), through a TMA
// descriptor cached per (device, pointer). Computes frames 0..n_frames-1
// of every clip, frame i starting at sample i*hop; bins n_used..n_bins-1
// must have all-zero mel rows. Clears the tile counters and launches the
// kernel on `stream`, without synchronising; returns the first CUDA error
// (0 on success), or tc::kEncodeMissing / kEncodeFailed + CUresult when
// the bases' descriptor cannot be made. split (tensor cores only): 0 lets
// the launcher choose how many blocks share a tile's K walk, 1, 2 or 4
// forces it (to time the choices).
int logmel_forward(const float* wav, const float* cos_b, const float* sin_b,
                   const float* split_b, const float* mel, const int* groups,
                   float* out, void* workspace, int batch, long long length,
                   int n_frames, int hop, int n_fft, int n_bins, int n_used,
                   int n_mels, int magnitude, float log_eps, int tensor_cores,
                   int split, void* stream) {
  if (batch < 1 || n_frames < 1 || hop < 1 || n_fft < 1 || n_mels < 1 ||
      n_used < 1 || n_used > n_bins ||
      n_chunks_for(n_used) > 1024 ||  // the reduction's table of groups
      static_cast<long long>(n_frames - 1) * hop + n_fft > length ||
      static_cast<long long>(batch) * n_frames > 0x7fffffffLL ||
      (split != 0 && split != 1 && split != 2 && split != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = batch * n_frames;
  float* partial = static_cast<float*>(workspace);
  int* done = reinterpret_cast<int*>(
      partial + static_cast<long long>(n_chunks_for(n_used)) * n_rows * n_mels);

  int device = 0;
  tc::Device dev;
  cudaError_t err = current_device(&device, &dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (tensor_cores) {
    const int n_chunks = n_chunks_for(n_used);
    const int k_stages = fast_stages(n_fft);
    const long long n_units = n_fast_units(batch, n_frames, n_used);
    const int pick = tc::pick_split(dev, n_units, k_stages, split);
    if (pick < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    CUtensorMap map;
    const int rc = tc::bases_map(device, split_b, k_stages,
                                 n_chunks * 2 * tc::kN, &map);
    if (rc != 0) return rc;
    err = cudaMemsetAsync(done, 0,
                          n_small_tiles(batch, n_frames) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = pick;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_units * pick));
    cfg.blockDim = dim3(tc::kThreads);
    cfg.dynamicSmemBytes = tc::kSmemBytes;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, tc::logmel_wgmma_kernel, map, wav, mel,
                             groups, out, partial, done, n_rows, n_frames,
                             length, hop, n_fft, k_stages, n_chunks, n_used,
                             n_mels, magnitude, log_eps, pick);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  err = cudaMemsetAsync(done, 0, n_small_tiles(batch, n_frames) * sizeof(int),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n_used + ffma::kChunk - 1) / ffma::kChunk;
  const int wide_tiles =
      (n_rows + ffma::Tile<8>::kFrames - 1) / ffma::Tile<8>::kFrames;
  if (static_cast<long long>(wide_tiles) * n_chunks >= 2LL * dev.n_sm) {
    ffma::logmel_ffma_kernel<8>
        <<<wide_tiles * n_chunks, ffma::kThreads, 0, s>>>(
        wav, cos_b, sin_b, mel, groups, out, partial, done, n_rows, n_frames,
        length, hop, n_fft, n_bins, n_used, n_mels, magnitude, log_eps,
        n_chunks);
  } else {
    ffma::logmel_ffma_kernel<4>
        <<<n_small_tiles(batch, n_frames) * n_chunks, ffma::kThreads, 0, s>>>(
            wav, cos_b, sin_b, mel, groups, out, partial, done, n_rows,
            n_frames, length, hop, n_fft, n_bins, n_used, n_mels, magnitude,
            log_eps, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
