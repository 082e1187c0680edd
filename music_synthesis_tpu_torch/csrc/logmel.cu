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
// "fast": the rDFT on the tensor cores, 3xTF32 (tc::logmel_tc_kernel).
// - Each operand x is split in registers into TF32 parts hi (its top 10
//   mantissa bits) and lo = x - hi, and lo*hi + hi*lo + hi*hi is summed in
//   fp32 by mma.sync.m16n8k8 (lo*lo, ~2^-22 relative, is dropped): fp32-
//   level accuracy at three tensor-core passes. The bases are stored once,
//   in fp32, in the order of the MMA's B fragments, so a thread reads its
//   cos and sin fragments of a k8 x n8 tile as one 16-byte word.
// - A thread holds re and im of the same frames and bins: the cos tile and
//   the sin tile of a bin group are two MMAs with the same fragment
//   mapping, so the power is squared out in registers.
// - A block is a tile of 64, 48 or 32 frames x 64 bins. Its frame samples
//   (each frame read in place, so a tile may cross a clip boundary) and
//   its slice of the bases arrive through a 3-stage cp.async ring of 16
//   samples per stage in dynamic shared memory: 16-byte copies when every
//   frame start is 16-byte aligned, 4-byte copies otherwise. Two stages are
//   in flight while the warps multiply the third. The blocks of a frame
//   tile's bin chunks are adjacent in the grid, so they run together.
// - On an H100 the loop is bound by moving operands (the ring and the
//   fragment loads from shared memory), not by the tensor cores: a build
//   with one MMA pass instead of three was barely faster. So the bases
//   travel in fp32 (bases stored as hi and lo doubled that stream and were
//   slower), and the launcher picks the frame tile from a cost model of
//   the three tiles' times: the larger the tile, the fewer bases per
//   frame, but the fewer blocks to spread over the SMs.
//
// "exact": fp32 FFMA (ffma::logmel_ffma_kernel). It accumulates in the
// order of the plain version's cuBLAS fp32 GEMM and agrees with it to ~1e-6
// in the log domain; the 3xTF32 path, rounded elsewhere, lands up to ~7e-4
// from it in near-silent mel bins, past the "exact" gate of 2e-4. A
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
// and called through ctypes (music_synthesis_tpu_torch/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

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
// "fast": 3xTF32 on the tensor cores.
namespace tc {

constexpr int kBN = kWsChunk;            // bins per block (each of cos, sin)
constexpr int kNT = kBN / 8;             // n8 tiles per block
constexpr int kBK = 16;                  // samples per ring stage
constexpr int kStages = 3;               // ring depth
constexpr int kAStride = kBK + 4;        // conflict-free A fragments
constexpr int kPsStride = kBN + 8;       // conflict-free float2 power stores
constexpr int kFragFloats = 32 * 4;      // one packed k8 x n8 tile, cos | sin
constexpr int kRunFloats = kNT * kFragFloats;  // a block's tiles of one k8
constexpr int kBStage = (kBK / 8) * kRunFloats;    // 8 KB

// A block of kWarpsM x kWarpsN warps; each warp owns kMT m16 tiles (16 kMT
// frames) x kNTW n8 tiles (8 kNTW bins), of both cos and sin.
template <int kWarpsM, int kWarpsN, int kMT, int kNTW>
struct Cfg {
  static constexpr int kWarps = kWarpsM * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kMT * kWarpsM;          // frames per block
  static constexpr int kAStage = kBM * kAStride;
  static constexpr int kStageFloats = kAStage + kBStage;
  static constexpr int kRingFloats = kStages * kStageFloats;
  static constexpr int kPsFloats = kBM * kPsStride;
  static constexpr int kSmemBytes = 4 * kRingFloats;
  static constexpr int kFpw = kBM / kWarps;               // mel-stage frames
  static constexpr int kAChunks = kBM * kBK / 4;          // 16-byte A chunks
  static constexpr int kAV =                               // per thread
      (kAChunks + kThreads - 1) / kThreads;
  static constexpr int kA4 = kBM * kBK / kThreads;        // 4-byte, per thread
  static constexpr int kB16 = (kBStage / 4 + kThreads - 1) / kThreads;  // B
  static_assert(kWarpsN * kNTW == kNT, "the warps cover the block's bins");
  static_assert(kA4 * kThreads == kBM * kBK, "4-byte A staging");
  static_assert(kPsFloats + 32 * kBN <= kRingFloats, "epilogue in the ring");
  static_assert(kFpw * kWarps == kBM, "mel-stage frames");
  static_assert(kAStage % 4 == 0 && kStageFloats % 4 == 0, "16-byte stages");
};

// x = hi + lo + O(2^-21 |x|) in TF32 operands: hi keeps the top 10
// mantissa bits of x, lo = x - hi is exact in fp32 and the MMA reads its
// top 10 (two instructions, no cvt).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col): TF32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0..16) bytes and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16_ca(float* dst, const float* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src)
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// bases: C and S in the order of the MMA's B fragments (ops/logmel.py,
// fragment_bases): [n_fft padded to kBK, / 8][n_nb][lane 4 g + t][C(k = t),
// C(k = t + 4), S(k = t), S(k = t + 4)] at bin 8 nb + g of each k8 x n8
// tile, zero past n_fft and n_used; k_stages = n_fft padded to kBK, / kBK.
// vec: every frame start is 16-byte aligned.
template <int kWarpsM, int kWarpsN, int kMT, int kNTW>
__global__ void __launch_bounds__(
    (Cfg<kWarpsM, kWarpsN, kMT, kNTW>::kThreads), 2)
logmel_tc_kernel(const float* __restrict__ wav,
                 const float* __restrict__ bases,
                 const float* __restrict__ mel,
                 const int* __restrict__ groups, float* __restrict__ out,
                 float* __restrict__ partial, int* __restrict__ done,
                 int n_rows, int n_frames, long long row_stride, int hop,
                 int n_fft, int k_stages, int n_nb, int n_used, int n_mels,
                 int magnitude, float log_eps, int vec) {
  using C = Cfg<kWarpsM, kWarpsN, kMT, kNTW>;
  const int n_chunks = n_nb / kNT;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  const int chunk = blockIdx.x % n_chunks;  // chunks of a tile run together
  const int row0 = blockIdx.x / n_chunks * C::kBM;
  const int nb0 = chunk * kNT;
  const int bin0 = chunk * kBN;

  // Start of frame row r (nullptr past the last row): clip r / n_frames,
  // frame r % n_frames, read in place.
  auto frame = [&](int r) -> const float* {
    if (r >= n_rows) return nullptr;
    const int b = r / n_frames;
    return wav + b * row_stride +
           static_cast<long long>(r - b * n_frames) * hop;
  };
  // The 16-byte path's copies of each stage: samples 4 q .. 4 q + 3 of
  // frame f, for chunk c = tid + i kThreads = 4 f + q < kAChunks.
  const float* a_src[C::kAV];
#pragma unroll
  for (int i = 0; i < C::kAV; ++i)
    a_src[i] = vec ? frame(row0 + (tid + i * C::kThreads) / (kBK / 4))
                   : nullptr;

  auto load_stage = [&](int kt, int slot) {
    float* sa = smem + slot * C::kStageFloats;
    float* sb = sa + C::kAStage;
    const int k0 = kt * kBK;
    if (vec) {
#pragma unroll
      for (int i = 0; i < C::kAV; ++i) {
        const int c = tid + i * C::kThreads;
        if (c >= C::kAChunks) break;
        const int q = c % (kBK / 4);
        const int k = k0 + 4 * q;
        const int bytes = a_src[i] ? max(0, min(16, 4 * (n_fft - k))) : 0;
        cp_async16_ca(sa + (c / (kBK / 4)) * kAStride + 4 * q,
                      bytes > 0 ? a_src[i] + k : wav, bytes);
      }
    } else {
      // 4-byte path (some frame start is not 16-byte aligned): sample
      // e % kBK of frame e / kBK, for e = tid + i kThreads.
#pragma unroll
      for (int i = 0; i < C::kA4; ++i) {
        const int e = tid + i * C::kThreads;
        const int k = k0 + e % kBK;
        const float* src = k < n_fft ? frame(row0 + e / kBK) : nullptr;
        cp_async4(sa + (e / kBK) * kAStride + e % kBK, src ? src + k : wav,
                  src ? 4 : 0);
      }
    }
    // The packed bases of k8 tiles kt kBK / 8 .., n8 tiles nb0 ..
    // nb0 + kNT - 1: one contiguous run of kRunFloats per k8 tile.
    const float* bsrc =
        bases + (static_cast<long long>(kt) * (kBK / 8) * n_nb + nb0) *
                    kFragFloats;
#pragma unroll
    for (int i = 0; i < C::kB16; ++i) {
      const int c = tid + i * C::kThreads;  // 16-byte chunk of the stage
      if (c >= kBStage / 4) break;
      const int run = c / (kRunFloats / 4);
      const int rest = c % (kRunFloats / 4);
      cp_async16_cg(sb + 4 * c,
                    bsrc + static_cast<long long>(run) * n_nb * kFragFloats +
                        4 * rest);
    }
  };

  float acc[kMT][kNTW][2][4];  // [m16 tile][n8 tile][cos | sin][fragment]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int cs = 0; cs < 2; ++cs)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][cs][q] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_stages) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_stages; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    __syncthreads();               // everyone's; and slot kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < k_stages) load_stage(next, next % kStages);
    cp_async_commit();

    const float* sa = smem + (kt % kStages) * C::kStageFloats;
    const float4* sb = reinterpret_cast<const float4*>(sa + C::kAStage);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // a0..a3: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
        const float* p =
            sa + ((warp_m * kMT + mt) * 16 + g) * kAStride + kk * 8 + t;
        const float v[4] = {p[0], p[8 * kAStride], p[4], p[8 * kAStride + 4]};
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(v[q], ah[mt][q], al[mt][q]);
      }
      // [n8 tile][cos | sin]: hi(t), hi(t + 4), lo(t), lo(t + 4).
      // b0, b1 of each n8 tile: (k = t, bin g), (k = t + 4, bin g), of
      // cos and of sin, from one 16-byte word.
      uint32_t bh[kNTW][2][2], bl[kNTW][2][2];  // [n8 tile][cos | sin][b0 | b1]
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        const float4 v = sb[(kk * kNT + warp_n * kNTW + j) * 32 + lane];
        split_tf32(v.x, bh[j][0][0], bl[j][0][0]);
        split_tf32(v.y, bh[j][0][1], bl[j][0][1]);
        split_tf32(v.z, bh[j][1][0], bl[j][1][0]);
        split_tf32(v.w, bh[j][1][1], bl[j][1][1]);
      }
      // Pass by pass over all accumulators, so that consecutive MMAs are
      // independent: lo*hi and hi*lo first, the large hi*hi last.
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < kNTW; ++j)
#pragma unroll
            for (int cs = 0; cs < 2; ++cs) {
              const bool lo_b = pass == 1;
              mma_tf32(acc[mt][j][cs], pass == 0 ? al[mt] : ah[mt],
                       lo_b ? bl[j][cs][0] : bh[j][cs][0],
                       lo_b ? bl[j][cs][1] : bh[j][cs][1]);
            }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory takes the power tile

  // c0..c3: (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1).
  float* ps = smem;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
      float pw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float re = acc[mt][j][0][q];
        const float im = acc[mt][j][1][q];
        const float v = re * re + im * im;
        pw[q] = magnitude ? sqrtf(v) : v;
      }
      const int r = (warp_m * kMT + mt) * 16 + g;
      const int col = (warp_n * kNTW + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(ps + r * kPsStride + col) =
          make_float2(pw[0], pw[1]);
      *reinterpret_cast<float2*>(ps + (r + 8) * kPsStride + col) =
          make_float2(pw[2], pw[3]);
    }
  __syncthreads();
  mel_epilogue<C::kFpw, C::kThreads>(ps, kPsStride, kBN, ps + C::kPsFloats,
                                     mel, groups, out, partial, done, &s_last,
                                     chunk, n_chunks, row0, n_rows, bin0,
                                     n_used, n_mels, log_eps);
}

// Launches the kernel with tiles of Cfg<kWarpsM, kWarpsN, kMT, kNTW>.
template <int kWarpsM, int kWarpsN, int kMT, int kNTW>
cudaError_t launch(cudaStream_t s, const float* wav, const float* bases,
                   const float* mel, const int* groups, float* out,
                   float* partial, int* done, int n_rows, int n_frames,
                   long long row_stride, int hop, int n_fft, int n_used,
                   int n_mels, int magnitude, float log_eps, int vec) {
  using C = Cfg<kWarpsM, kWarpsN, kMT, kNTW>;
  static_assert(C::kBM >= kSmallTile, "the workspace counts 16-frame tiles");
  const auto kernel = logmel_tc_kernel<kWarpsM, kWarpsN, kMT, kNTW>;
  const int n_tiles = (n_rows + C::kBM - 1) / C::kBM;
  const int n_nb = (n_used + kBN - 1) / kBN * kNT;
  const int k_stages = (n_fft + kBK - 1) / kBK;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles * (n_nb / kNT), C::kThreads, C::kSmemBytes, s>>>(
      wav, bases, mel, groups, out, partial, done, n_rows, n_frames,
      row_stride, hop, n_fft, k_stages, n_nb, n_used, n_mels, magnitude,
      log_eps, vec);
  return cudaGetLastError();
}

}  // namespace tc

int n_chunks_for(int n_used) { return (n_used + kWsChunk - 1) / kWsChunk; }

long long n_small_tiles(int batch, int n_frames) {
  return (static_cast<long long>(batch) * n_frames + kSmallTile - 1) /
         kSmallTile;
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

// wav [batch, length] fp32 (already padded), mel [n_bins, n_mels] (any
// n_mels >= 1), groups [ceil(n_used / 64), 2] (the first and last 32-mel
// group with a non-zero weight in each 64-bin chunk), out [batch, n_frames,
// n_mels], workspace of logmel_workspace_words(...) words. tensor_cores = 0
// ("exact") reads the fp32 bases cos_b / sin_b [n_fft, n_bins];
// tensor_cores = 1 ("fast") reads the same bases packed in fragment order,
// `packed` (layout at tc::logmel_tc_kernel). Computes frames
// 0..n_frames-1 of every clip, frame i starting at sample i*hop; bins
// n_used..n_bins-1 must have all-zero mel rows. Clears the tile counters
// and launches the kernel on `stream`, without synchronising; returns the
// first CUDA error (0 on success). tile_frames (tensor cores only): 0 lets
// the launcher choose the frame tile, 64, 48 or 32 forces it (to time the
// tiles).
int logmel_forward(const float* wav, const float* cos_b, const float* sin_b,
                   const float* packed, const float* mel, const int* groups,
                   float* out, void* workspace, int batch, long long length,
                   int n_frames, int hop, int n_fft, int n_bins, int n_used,
                   int n_mels, int magnitude, float log_eps, int tensor_cores,
                   int tile_frames, void* stream) {
  if (batch < 1 || n_frames < 1 || hop < 1 || n_fft < 1 || n_mels < 1 ||
      n_used < 1 || n_used > n_bins ||
      n_chunks_for(n_used) > 1024 ||  // the reduction's table of groups
      static_cast<long long>(n_frames - 1) * hop + n_fft > length ||
      static_cast<long long>(batch) * n_frames > 0x7fffffffLL ||
      (tile_frames != 0 && tile_frames != 64 && tile_frames != 48 &&
       tile_frames != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = batch * n_frames;
  float* partial = static_cast<float*>(workspace);
  int* done = reinterpret_cast<int*>(
      partial + static_cast<long long>(n_chunks_for(n_used)) * n_rows * n_mels);
  cudaError_t err =
      cudaMemsetAsync(done, 0, n_small_tiles(batch, n_frames) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (tensor_cores) {
    const int vec = length % 4 == 0 && hop % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(wav) % 16 == 0;
    // Tiles of 64, 48 or 32 frames: the one whose busiest SM has the least
    // work, ceil(blocks / SMs) x frames x the tile's time per frame
    // relative to 64-frame tiles (1, 1.2, 1.25: from chip_smoke.py's
    // timings of the three tiles on an H100, PERF.md).
    const long long chunks = n_chunks_for(n_used);
    const int frames[3] = {64, 48, 32};
    const double cost[3] = {1.0, 1.2, 1.25};
    int pick = 0;
    double best = 0.0;
    for (int i = 0; i < 3; ++i) {
      const long long blocks = (n_rows + frames[i] - 1) / frames[i] * chunks;
      const double load =
          static_cast<double>((blocks + n_sm - 1) / n_sm) * frames[i] * cost[i];
      if (i == 0 || load < best) best = load, pick = i;
      if (tile_frames == frames[i]) {
        pick = i;
        break;
      }
    }
#define LOGMEL_TC(...)                                                       \
  tc::launch<__VA_ARGS__>(s, wav, packed, mel, groups, out, partial, done,   \
                          n_rows, n_frames, length, hop, n_fft, n_used,      \
                          n_mels, magnitude, log_eps, vec)
    err = pick == 0   ? LOGMEL_TC(2, 2, 2, 4)   // 4 warps of 32 x 32 bins
          : pick == 1 ? LOGMEL_TC(3, 2, 1, 4)   // 6 warps of 16 x 32 bins
                      : LOGMEL_TC(1, 4, 2, 2);  // 4 warps of 32 x 16 bins
#undef LOGMEL_TC
    return static_cast<int>(err);
  }

  const int n_chunks = (n_used + ffma::kChunk - 1) / ffma::kChunk;
  const int wide_tiles =
      (n_rows + ffma::Tile<8>::kFrames - 1) / ffma::Tile<8>::kFrames;
  if (static_cast<long long>(wide_tiles) * n_chunks >= 2LL * n_sm) {
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
