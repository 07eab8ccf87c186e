// Native host runtime: WAV decode, polyphase resample, SNR mixing.
//
// The reference delegates this work to librosa/soundfile/resampy (C
// libraries behind Python wrappers, SURVEY.md SS2.2); this is the
// framework's own native implementation, driven from Python via ctypes.
// Calls release the GIL for their full duration, so the existing
// thread-pool loader gets true parallel decode on host CPUs.
//
// Resampler: polyphase upfirdn with a Kaiser(5.0)-windowed sinc low-pass,
// the same filter family and parameters as scipy.signal.resample_poly's
// default (half_len = 10*max(up,down), cutoff = 1/max(up,down)), so the
// native and Python paths agree to float tolerance.
//
// Build: g++, on first use, by ../data/native.py (native.build()).
// API contract mirrored in ../data/native.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

void fcse_free(float* p) { std::free(p); }

// ---------------------------------------------------------------------------
// WAV decode (PCM 8/16/24/32-bit and IEEE float32/64, mono-mixdown)
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Returns 0 on success; *out is malloc'd (caller frees via fcse_free).
int fcse_decode_wav(const char* path, float** out, int64_t* n_out,
                    int32_t* sr_out) {
  *out = nullptr;
  *n_out = 0;
  *sr_out = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 44) {
    std::fclose(f);
    return 2;
  }
  std::vector<uint8_t> buf((size_t)size);
  if (std::fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);
  if (std::memcmp(buf.data(), "RIFF", 4) || std::memcmp(buf.data() + 8, "WAVE", 4))
    return 4;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    uint32_t chunk_len = rd_u32(&buf[pos + 4]);
    if (!std::memcmp(&buf[pos], "fmt ", 4) && pos + 8 + 16 <= (size_t)size) {
      fmt = rd_u16(&buf[pos + 8]);
      channels = rd_u16(&buf[pos + 10]);
      sr = rd_u32(&buf[pos + 12]);
      bits = rd_u16(&buf[pos + 22]);
    } else if (!std::memcmp(&buf[pos], "data", 4)) {
      data = &buf[pos + 8];
      data_len = chunk_len;
      if (pos + 8 + data_len > (size_t)size) data_len = (uint32_t)(size - pos - 8);
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || !channels || !sr) return 5;
  if (fmt == 0xFFFE) fmt = 1;  // extensible: assume PCM subformat

  int bytes = bits / 8;
  if (bytes == 0) return 6;
  int64_t frames = data_len / (bytes * channels);
  float* y = (float*)std::malloc(sizeof(float) * (size_t)frames);
  if (!y) return 7;

  for (int64_t i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = data + (i * channels + c) * bytes;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {
        float fv;
        std::memcpy(&fv, p, 4);
        v = fv;
      } else if (fmt == 3 && bits == 64) {
        double dv;
        std::memcpy(&dv, p, 8);
        v = dv;
      } else if (bits == 16) {
        int16_t s = (int16_t)(p[0] | (p[1] << 8));
        v = s / 32768.0;
      } else if (bits == 24) {
        int32_t s = (p[0] | (p[1] << 8) | (p[2] << 16));
        if (s & 0x800000) s |= ~0xFFFFFF;
        v = s / 8388608.0;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      } else {
        std::free(y);
        return 8;
      }
      acc += v;
    }
    y[i] = (float)(acc / channels);
  }
  *out = y;
  *n_out = frames;
  *sr_out = (int32_t)sr;
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampler (scipy resample_poly-compatible filter design)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion; converges fast for the beta range used here
  double sum = 1.0, term = 1.0, x2 = x * x / 4.0;
  for (int k = 1; k < 64; k++) {
    term *= x2 / (k * (double)k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

static std::vector<double> kaiser_sinc(int64_t up, int64_t down) {
  // firwin(2*half_len+1, 1/max(up,down), window=('kaiser', 5.0)),
  // scaled by `up` (resample_poly's gain correction)
  int64_t m = up > down ? up : down;
  int64_t half = 10 * m;
  int64_t n = 2 * half + 1;
  double fc = 1.0 / m;  // normalized cutoff (Nyquist = 1)
  double beta = 5.0;
  double denom = bessel_i0(beta);
  std::vector<double> h((size_t)n);
  double sum = 0.0;
  for (int64_t i = 0; i < n; i++) {
    double t = (double)(i - half);
    double sinc = (t == 0.0) ? fc : std::sin(M_PI * fc * t) / (M_PI * t);
    double r = 2.0 * (double)i / (double)(n - 1) - 1.0;
    double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / denom;
    h[(size_t)i] = sinc * w;
    sum += h[(size_t)i];
  }
  for (auto& v : h) v *= (double)up / sum;  // unity DC gain, x up
  return h;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

int fcse_resample(const float* in, int64_t n, int32_t sr, int32_t target,
                  float** out, int64_t* out_n) {
  if (sr == target) {
    float* y = (float*)std::malloc(sizeof(float) * (size_t)n);
    std::memcpy(y, in, sizeof(float) * (size_t)n);
    *out = y;
    *out_n = n;
    return 0;
  }
  int64_t g = gcd64(sr, target);
  int64_t up = target / g, down = sr / g;
  std::vector<double> h = kaiser_sinc(up, down);
  int64_t half = ((int64_t)h.size() - 1) / 2;
  // upfirdn semantics with output length ceil(n*up/down) and group-delay
  // compensation of half taps (matches scipy.resample_poly's trimming)
  int64_t out_len = (n * up + down - 1) / down;
  float* y = (float*)std::malloc(sizeof(float) * (size_t)out_len);
  if (!y) return 1;
  for (int64_t k = 0; k < out_len; k++) {
    // output sample k taps the upsampled stream at position k*down + half
    int64_t pos = k * down + half;
    double acc = 0.0;
    // upsampled stream: x_up[j] = in[j/up] when j%up==0
    // convolve: y[pos] = sum_t h[t] * x_up[pos - t]
    // only t with (pos - t) % up == 0 contribute
    int64_t j_hi = pos / up;            // highest input index with tap
    int64_t t0 = pos - j_hi * up;       // smallest tap index used
    for (int64_t t = t0, j = j_hi; t < (int64_t)h.size(); t += up, j--) {
      if (j < 0) break;
      if (j < n) acc += h[(size_t)t] * (double)in[j];
    }
    y[k] = (float)acc;
  }
  *out = y;
  *out_n = out_len;
  return 0;
}

// ---------------------------------------------------------------------------
// SNR mixing (reference add_noise semantics, data_loader.py:35-52)
// ---------------------------------------------------------------------------

int fcse_mix_at_snr(const float* speech, int64_t n_speech, const float* noise_in,
                    int64_t n_noise, double snr_db, uint64_t seed, float* out) {
  if (n_speech <= 0 || n_noise <= 0) return 1;
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  std::vector<float> noise;
  if (n_speech >= n_noise) {
    // reference: repeated self-doubling with uniform(0,2) gain per round
    noise.assign(noise_in, noise_in + n_noise);
    int64_t diff = n_speech - n_noise;
    int64_t rounds = (diff + n_noise - 1) / n_noise;
    for (int64_t r = 0; r < rounds; r++) {
      double gain = uni(rng) * 2.0;
      size_t cur = noise.size();
      noise.resize(cur * 2);
      for (size_t i = 0; i < cur; i++) noise[cur + i] = (float)(noise[i] * gain);
    }
    noise.resize((size_t)n_speech);
  } else {
    int64_t start = (int64_t)(uni(rng) * (double)(n_noise - n_speech));
    if (start > n_noise - n_speech) start = n_noise - n_speech;
    noise.assign(noise_in + start, noise_in + start + n_speech);
  }
  double p_sig = 0.0, p_noise = 0.0;
  for (int64_t i = 0; i < n_speech; i++) p_sig += (double)speech[i] * speech[i];
  for (int64_t i = 0; i < n_speech; i++) p_noise += (double)noise[(size_t)i] * noise[(size_t)i];
  if (p_noise <= 0.0) {
    std::memcpy(out, speech, sizeof(float) * (size_t)n_speech);
    return 0;
  }
  double target = p_sig / std::pow(10.0, snr_db / 10.0);
  double scale = std::sqrt(target / p_noise);
  for (int64_t i = 0; i < n_speech; i++)
    out[i] = speech[i] + (float)(scale * noise[(size_t)i]);
  return 0;
}

// ---------------------------------------------------------------------------
// Fused item pipeline: decode + resample (+ decode noise + mix)
// ---------------------------------------------------------------------------

int fcse_prepare_item(const char* clean_path, const char* noise_path,
                      int32_t target_sr, double snr_db, uint64_t seed,
                      float** mix_out, float** clean_out, int64_t* n_out) {
  float* raw = nullptr;
  int64_t n = 0;
  int32_t sr = 0;
  int rc = fcse_decode_wav(clean_path, &raw, &n, &sr);
  if (rc) return 100 + rc;
  float* clean = raw;
  if (sr != target_sr) {
    rc = fcse_resample(raw, n, sr, target_sr, &clean, &n);
    std::free(raw);
    if (rc) return 200 + rc;
  }
  float* mix = (float*)std::malloc(sizeof(float) * (size_t)n);
  if (!mix) {
    std::free(clean);
    return 3;
  }
  if (noise_path && noise_path[0]) {
    float* nraw = nullptr;
    int64_t nn = 0;
    int32_t nsr = 0;
    rc = fcse_decode_wav(noise_path, &nraw, &nn, &nsr);
    if (rc) {
      std::free(clean);
      std::free(mix);
      return 300 + rc;
    }
    float* noise = nraw;
    if (nsr != target_sr) {
      rc = fcse_resample(nraw, nn, nsr, target_sr, &noise, &nn);
      std::free(nraw);
      if (rc) {
        std::free(clean);
        std::free(mix);
        return 400 + rc;
      }
    }
    rc = fcse_mix_at_snr(clean, n, noise, nn, snr_db, seed, mix);
    std::free(noise);
    if (rc) {
      std::free(clean);
      std::free(mix);
      return 500 + rc;
    }
  } else {
    std::memcpy(mix, clean, sizeof(float) * (size_t)n);
  }
  *mix_out = mix;
  *clean_out = clean;
  *n_out = n;
  return 0;
}

}  // extern "C"
