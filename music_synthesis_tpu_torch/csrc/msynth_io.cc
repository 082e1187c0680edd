// Native host-side audio IO for the TPU music-synthesis framework.
//
// The device side of this framework is JAX/XLA/Pallas; the host side feeds
// it. This library keeps the (single-core) host out of the training loop's
// critical path: RIFF/WAVE decoding, channel downmix, and rational
// sample-rate conversion (polyphase windowed-sinc) in C++, exposed through a
// minimal C ABI consumed via ctypes (music_synthesis_tpu/data/native.py).
//
// Build: scripts/build_native.sh  (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  bool skip(size_t k) {
    if (off + k > n) return ok = false;
    off += k;
    return true;
  }
  bool read(void* dst, size_t k) {
    if (off + k > n) return ok = false;
    std::memcpy(dst, p + off, k);
    off += k;
    return true;
  }
  uint32_t u32() {
    uint32_t v = 0;
    read(&v, 4);
    return v;
  }
  uint16_t u16() {
    uint16_t v = 0;
    read(&v, 2);
    return v;
  }
};

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Modified Bessel function of the first kind, order zero (for Kaiser).
double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Parses a RIFF/WAVE buffer; returns sample count written to *out_len and
// sample rate to *out_rate. Caller passes a capacity-limited output buffer;
// call first with out=nullptr to query the required length.
// Supports PCM 8/16/24/32-bit and IEEE float32/64, any channel count
// (downmixed to mono). Returns 0 on success, negative error codes otherwise.
int msynth_decode_wav(const uint8_t* data, int64_t size, float* out,
                      int64_t out_capacity, int64_t* out_len,
                      int32_t* out_rate) {
  Reader r{data, static_cast<size_t>(size)};
  char tag[5] = {0};
  if (!r.read(tag, 4) || std::strncmp(tag, "RIFF", 4) != 0) return -1;
  r.u32();  // riff size
  if (!r.read(tag, 4) || std::strncmp(tag, "WAVE", 4) != 0) return -1;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_bytes = 0;

  while (r.ok && r.off + 8 <= r.n) {
    if (!r.read(tag, 4)) break;
    uint32_t chunk = r.u32();
    if (std::strncmp(tag, "fmt ", 4) == 0) {
      size_t start = r.off;
      fmt = r.u16();
      channels = r.u16();
      rate = r.u32();
      r.u32();  // byte rate
      r.u16();  // block align
      bits = r.u16();
      if (fmt == 0xFFFE && chunk >= 24) {  // WAVE_FORMAT_EXTENSIBLE
        r.u16();                           // cbSize
        r.u16();                           // valid bits
        r.u32();                           // channel mask
        fmt = r.u16();                     // subformat leading GUID bytes
      }
      r.off = start;
      r.skip(chunk + (chunk & 1));
    } else if (std::strncmp(tag, "data", 4) == 0) {
      if (r.off + chunk > r.n) chunk = static_cast<uint32_t>(r.n - r.off);
      pcm = data + r.off;
      pcm_bytes = chunk;
      r.skip(chunk + (chunk & 1));
    } else {
      r.skip(chunk + (chunk & 1));
    }
  }
  if (!pcm || channels == 0 || rate == 0) return -2;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return -3;
  size_t frames = pcm_bytes / (bytes_per * channels);
  *out_len = static_cast<int64_t>(frames);
  *out_rate = static_cast<int32_t>(rate);
  if (out == nullptr) return 0;
  if (out_capacity < static_cast<int64_t>(frames)) return -4;

  const double inv_ch = 1.0 / channels;
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (unsigned c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {  // IEEE float
        float f;
        std::memcpy(&f, s, 4);
        v = f;
      } else if (fmt == 3 && bits == 64) {
        double d;
        std::memcpy(&d, s, 8);
        v = d;
      } else if (bits == 16) {
        int16_t x;
        std::memcpy(&x, s, 2);
        v = x / 32768.0;
      } else if (bits == 24) {
        // Compose in unsigned space (signed left-shift of negatives is UB
        // pre-C++20), then arithmetic-shift back down to sign-extend.
        uint32_t u = (static_cast<uint32_t>(s[0]) << 8) |
                     (static_cast<uint32_t>(s[1]) << 16) |
                     (static_cast<uint32_t>(s[2]) << 24);
        int32_t x = static_cast<int32_t>(u) >> 8;
        v = x / 8388608.0;
      } else if (bits == 32) {
        int32_t x;
        std::memcpy(&x, s, 4);
        v = x / 2147483648.0;
      } else if (bits == 8) {
        v = (s[0] - 128) / 128.0;
      } else {
        return -5;
      }
      acc += v;
    }
    out[i] = static_cast<float>(acc * inv_ch);
  }
  return 0;
}

// Polyphase rational resampler (up/down), Kaiser-windowed sinc prototype.
// Matches scipy.signal.resample_poly's output length: ceil(n * up / down).
// Call with out=nullptr to query the output length via *out_len.
int msynth_resample(const float* in, int64_t n, int32_t sr_in, int32_t sr_out,
                    float* out, int64_t out_capacity, int64_t* out_len) {
  if (sr_in <= 0 || sr_out <= 0 || n <= 0) return -1;
  int g = gcd(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;
  int64_t n_out = (n * up + down - 1) / down;
  *out_len = n_out;
  if (out == nullptr) return 0;
  if (out_capacity < n_out) return -4;
  if (up == 1 && down == 1) {
    std::memcpy(out, in, n * sizeof(float));
    return 0;
  }

  // Prototype lowpass matching scipy.signal.resample_poly's default design:
  // half-width 10 zero crossings at the up-rate, Kaiser beta 5.0, cutoff
  // 1/max(up, down), DC gain normalized to `up` (firwin scale=True).
  const int64_t max_rate = up > down ? up : down;
  const int64_t half = 10 * max_rate;  // taps each side at the up-rate
  const double cutoff = 1.0 / static_cast<double>(max_rate);
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  std::vector<double> h(2 * half + 1);
  double dc = 0.0;
  for (int64_t k = -half; k <= half; ++k) {
    double t = static_cast<double>(k);
    double sinc = (k == 0) ? cutoff : std::sin(kPi * cutoff * t) / (kPi * t);
    double w = t / static_cast<double>(half);
    double kaiser = bessel_i0(beta * std::sqrt(1.0 - w * w)) / i0b;
    h[k + half] = sinc * kaiser;
    dc += h[k + half];
  }
  const double gain = static_cast<double>(up) / dc;
  for (double& v : h) v *= gain;

  // out[m] = sum_k h[m*down - i*up + half] * in[i]  (polyphase evaluation)
  for (int64_t m = 0; m < n_out; ++m) {
    const int64_t t_up = m * down;  // position at the up-rate grid
    // h index j = t_up - i*up + half in [0, 2*half]
    int64_t i_min = (t_up - half + up - 1) / up;  // ceil
    int64_t i_max = (t_up + half) / up;           // floor
    if (i_min < 0) i_min = 0;
    if (i_max >= n) i_max = n - 1;
    double acc = 0.0;
    for (int64_t i = i_min; i <= i_max; ++i) {
      acc += h[t_up - i * up + half] * in[i];
    }
    out[m] = static_cast<float>(acc);
  }
  return 0;
}

}  // extern "C"
