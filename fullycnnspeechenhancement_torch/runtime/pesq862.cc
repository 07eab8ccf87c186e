// P.862-structured PESQ (narrowband, 8 kHz) -- native implementation.
//
// The reference scores enhancement quality with pypesq, a wrapper over the
// ITU-T P.862 reference C code (the reference's model_utils/utils.py:32-45);
// that package (and its conformance-tested code) is not available in this
// image, so this file implements the published P.862 algorithm structure
// from the spec (Rix, Beerends, Hollier, Hekstra: "Perceptual evaluation
// of speech quality", ICASSP 2001 / ITU-T Rec. P.862) from scratch:
//
//   1. IRS-receive-style bandpass filtering of both signals (FFT domain);
//   2. level alignment of both signals to a fixed listening level over
//      the 300-3000 Hz band;
//   3. time alignment: envelope cross-correlation (4 ms log-energy
//      frames) for the crude delay, waveform cross-correlation for the
//      fine delay, then ITU-style UTTERANCE-LEVEL re-alignment: a VAD
//      on the level-aligned reference splits it into speech utterances
//      (200 ms gap merging, 300 ms minimum) and each utterance's delay
//      is re-estimated individually (+-100 ms around the global delay),
//      so time-VARYING delay -- e.g. a network delay jump mid-file --
//      is scored correctly (P.862 SS8.2 structure);
//   4. perceptual model: 32 ms Hann frames at 50% overlap -> power
//      spectra -> 42 Bark-warped bands (pitch power densities) ->
//      per-band frequency compensation and per-frame short-term gain
//      compensation -> Zwicker loudness -> masked loudness-difference
//      disturbance with an asymmetry (additive-distortion) factor ->
//      weighted band norms -> L6-over-split-seconds / L2-over-file
//      aggregation -> MOS-scale score 4.5 - a*D - b*DA.
//
// Conformance caveat (documented, also in eval/metrics.py): without the
// ITU tables this is NOT bit-compatible with P.862; band edges come from
// the Schroeder Bark warping, the absolute hearing threshold from
// Terhardt's formula, and the disturbance scale is calibrated on anchor
// conditions (identity -> 4.5, heavy noise -> ~1, monotone in SNR).  It
// is a real perceptual model in the P.862 family, not a proxy SNR.
//
// Exposed via ctypes in ../data/native.py; scored through
// eval/metrics.PESQ.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

constexpr int kSr = 8000;
constexpr int kFrame = 256;   // 32 ms
constexpr int kHop = 128;     // 50% overlap
constexpr int kNumBands = 42; // narrowband Bark bands
constexpr double kLevelTarget = 1e7;  // aligned band power ("~79 dB SPL")
constexpr double kSplitFrames = 20;   // ~320 ms split-second intervals
constexpr double kZwickerPow = 0.23;
constexpr double kSl = 1.866055e-1;   // loudness scale (Zwicker, sone)
// MOS mapping coefficients, calibrated on anchor conditions (see the
// extern "C" footer and tests/test_metrics.py): identity -> 4.5 by
// construction; white noise at 0 dB SNR -> ~1.4; at 20 dB -> ~2.9.
constexpr double kCoefD = 0.56;
constexpr double kCoefDA = 0.134;

// ---------------------------------------------------------------------------
// FFT: iterative radix-2, double precision
// ---------------------------------------------------------------------------

void fft_radix2(std::vector<double>& re, std::vector<double>& im, bool inv) {
  const size_t n = re.size();
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / (double)len * (inv ? 1.0 : -1.0);
    double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; k++) {
        size_t a = i + k, b = i + k + len / 2;
        double tr = re[b] * cr - im[b] * ci;
        double ti = re[b] * ci + im[b] * cr;
        re[b] = re[a] - tr;
        im[b] = im[a] - ti;
        re[a] += tr;
        im[a] += ti;
        double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
  if (inv) {
    for (size_t i = 0; i < n; i++) {
      re[i] /= (double)n;
      im[i] /= (double)n;
    }
  }
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// Bark bands and hearing threshold
// ---------------------------------------------------------------------------

double hz_to_bark(double f) { return 7.0 * std::asinh(f / 650.0); }
double bark_to_hz(double z) { return 650.0 * std::sinh(z / 7.0); }

// Terhardt's threshold in quiet, dB SPL (f in kHz).
double abs_thresh_db(double f_khz) {
  if (f_khz < 0.02) f_khz = 0.02;
  return 3.64 * std::pow(f_khz, -0.8) -
         6.5 * std::exp(-0.6 * (f_khz - 3.3) * (f_khz - 3.3)) +
         1e-3 * std::pow(f_khz, 4.0);
}

struct BarkBands {
  int lo_bin[kNumBands];
  int hi_bin[kNumBands];       // exclusive
  double center_hz[kNumBands];
  double thresh[kNumBands];    // absolute threshold, intensity (0 dB SPL = 1)
  double width[kNumBands];     // bark width (uniform) -- norm weights
};

BarkBands make_bands() {
  BarkBands b{};
  const double z_max = hz_to_bark(kSr / 2.0);
  const double dz = z_max / kNumBands;
  const double bin_hz = (double)kSr / kFrame;  // 31.25 Hz
  for (int k = 0; k < kNumBands; k++) {
    double f_lo = bark_to_hz(k * dz);
    double f_hi = bark_to_hz((k + 1) * dz);
    int lo = (int)std::ceil(f_lo / bin_hz - 1e-9);
    int hi = (int)std::ceil(f_hi / bin_hz - 1e-9);
    if (hi <= lo) hi = lo + 1;
    if (hi > kFrame / 2 + 1) hi = kFrame / 2 + 1;
    b.lo_bin[k] = lo;
    b.hi_bin[k] = hi;
    b.center_hz[k] = 0.5 * (f_lo + f_hi);
    b.thresh[k] = std::pow(10.0, abs_thresh_db(b.center_hz[k] / 1000.0) / 10.0);
    b.width[k] = dz;
  }
  return b;
}

// ---------------------------------------------------------------------------
// Preprocessing: IRS-style receive filter + level alignment
// ---------------------------------------------------------------------------

// Approximate IRS receive characteristic: piecewise-linear dB gain over
// log-frequency (bandpass 300..3400 with a mild presence rise; values
// follow the published IRS receive shape, not the ITU table).
double irs_gain_db(double f) {
  static const double tab[][2] = {
      {0, -200},   {50, -40}, {100, -20}, {150, -12}, {200, -8}, {250, -4},
      {300, -2},   {350, 0},  {400, 1},   {500, 2},   {700, 3},  {1000, 3},
      {1600, 4},   {2000, 4}, {2500, 5},  {3000, 5},  {3250, 4}, {3400, 0},
      {3600, -10}, {4000, -80},
  };
  const int n = sizeof(tab) / sizeof(tab[0]);
  if (f <= tab[0][0]) return tab[0][1];
  for (int i = 1; i < n; i++) {
    if (f <= tab[i][0]) {
      double t = (f - tab[i - 1][0]) / (tab[i][0] - tab[i - 1][0]);
      return tab[i - 1][1] + t * (tab[i][1] - tab[i - 1][1]);
    }
  }
  return tab[n - 1][1];
}

// Filter in the FFT domain and measure 300-3000 Hz band power.
void irs_filter_and_band_power(std::vector<double>& x, double* band_power) {
  const size_t n = x.size();
  const size_t nfft = next_pow2(n);
  std::vector<double> re(nfft, 0.0), im(nfft, 0.0);
  std::copy(x.begin(), x.end(), re.begin());
  fft_radix2(re, im, false);
  double bp = 0.0;
  for (size_t k = 0; k <= nfft / 2; k++) {
    double f = (double)k * kSr / (double)nfft;
    double g = std::pow(10.0, irs_gain_db(f) / 20.0);
    size_t k2 = (k == 0 || 2 * k == nfft) ? k : nfft - k;
    re[k] *= g;
    im[k] *= g;
    if (k2 != k) {
      re[k2] *= g;
      im[k2] *= g;
    }
    if (f >= 300.0 && f <= 3000.0) bp += (re[k] * re[k] + im[k] * im[k]) * 2.0;
  }
  *band_power = bp / ((double)nfft * (double)n);  // mean-square in band
  fft_radix2(re, im, true);
  for (size_t i = 0; i < n; i++) x[i] = re[i];
}

// ---------------------------------------------------------------------------
// Time alignment (constant whole-file delay)
// ---------------------------------------------------------------------------

// Cross-correlate log-energy envelopes (4 ms frames); returns delay of
// `deg` relative to `ref` in samples (positive = deg lags).
int64_t envelope_delay(const std::vector<double>& ref,
                       const std::vector<double>& deg) {
  const int env_hop = 32;  // 4 ms
  auto envelope = [&](const std::vector<double>& x) {
    size_t n_fr = x.size() / env_hop;
    std::vector<double> e(n_fr);
    for (size_t i = 0; i < n_fr; i++) {
      double s = 0.0;
      for (int j = 0; j < env_hop; j++) {
        double v = x[i * env_hop + j];
        s += v * v;
      }
      e[i] = std::log10(s / env_hop + 1e4);
    }
    // remove mean so silence doesn't correlate
    double m = 0.0;
    for (double v : e) m += v;
    m /= (double)e.size();
    for (double& v : e) v -= m;
    return e;
  };
  std::vector<double> er = envelope(ref), ed = envelope(deg);
  size_t n = std::max(er.size(), ed.size());
  size_t nfft = next_pow2(2 * n);
  std::vector<double> ar(nfft, 0.0), ai(nfft, 0.0), br(nfft, 0.0), bi(nfft, 0.0);
  std::copy(er.begin(), er.end(), ar.begin());
  std::copy(ed.begin(), ed.end(), br.begin());
  fft_radix2(ar, ai, false);
  fft_radix2(br, bi, false);
  // conj(A) * B
  for (size_t k = 0; k < nfft; k++) {
    double rr = ar[k] * br[k] + ai[k] * bi[k];
    double ii = ar[k] * bi[k] - ai[k] * br[k];
    ar[k] = rr;
    ai[k] = ii;
  }
  fft_radix2(ar, ai, true);
  int64_t best = 0;
  double best_v = -1e300;
  int64_t max_lag = (int64_t)std::min<size_t>(er.size(), nfft / 2);
  for (int64_t lag = -max_lag + 1; lag < max_lag; lag++) {
    double v = ar[(size_t)((lag + (int64_t)nfft) % (int64_t)nfft)];
    if (v > best_v) {
      best_v = v;
      best = lag;
    }
  }
  return best * env_hop;
}

// Refine around the crude delay by direct waveform cross-correlation:
// coarse scan (stride-4 candidates over +-radius, strided samples), then
// exact scan of +-4 around the coarse winner.  The crude envelope delay
// can be off by several envelope hops when the modulation is slow, so the
// radius must cover that.
int64_t scan_delay(const std::vector<double>& ref, const std::vector<double>& deg,
                   int64_t center, int64_t radius, int64_t step) {
  int64_t best = center;
  double best_v = -1e300;
  for (int64_t d = center - radius; d <= center + radius; d += step) {
    double acc = 0.0;
    int64_t start = std::max<int64_t>(0, d);
    int64_t stop = std::min<int64_t>((int64_t)ref.size(), (int64_t)deg.size() + d);
    if (stop - start < kFrame) continue;
    for (int64_t i = start; i < stop; i++)
      acc += ref[(size_t)i] * deg[(size_t)(i - d)];
    // overlap-normalized: candidates truncate different amounts at the
    // file edges, and un-normalized correlation biases toward the
    // longer overlap (which can be a pitch-period alias for periodic
    // content)
    double v = acc / (double)(stop - start);
    if (v > best_v) {
      best_v = v;
      best = d;
    }
  }
  return best;
}

int64_t fine_delay(const std::vector<double>& ref, const std::vector<double>& deg,
                   int64_t crude, int64_t radius) {
  int64_t coarse = scan_delay(ref, deg, crude, radius, 4);
  return scan_delay(ref, deg, coarse, 4, 1);
}

// ---------------------------------------------------------------------------
// Utterance-level re-alignment (ITU P.862 SS8.2-style)
// ---------------------------------------------------------------------------
//
// The ITU algorithm splits the reference into speech utterances via a
// VAD on the level-aligned reference, then re-estimates the delay of
// each utterance individually (networks introduce time-varying delay;
// a constant whole-file delay mis-scores every utterance after a delay
// jump).  This implements that structure: 4 ms log-energy VAD with
// hangover merging, then per-utterance coarse+fine waveform
// cross-correlation around the global delay, and a rebuilt degraded
// timeline with each utterance shifted by its own delay.

struct Utterance {
  size_t start, stop;  // sample range in the (aligned) reference
};

std::vector<Utterance> segment_utterances(const std::vector<double>& ref) {
  const int hop = 32;  // 4 ms
  const size_t n_fr = ref.size() / hop;
  std::vector<Utterance> out;
  if (n_fr == 0) return out;
  std::vector<double> e(n_fr);
  double emax = 0.0;
  for (size_t i = 0; i < n_fr; i++) {
    double s = 0.0;
    for (int j = 0; j < hop; j++) {
      double v = ref[i * hop + j];
      s += v * v;
    }
    e[i] = s / hop;
    emax = std::max(emax, e[i]);
  }
  if (emax <= 0.0) return out;
  const double thresh = emax * 1e-4;  // -40 dB below the loudest frame
  // active flags with gap merging (<= 200 ms of silence joins utterances,
  // the ITU "minimum silence between utterances")
  const size_t min_gap = 50;   // 200 ms
  const size_t min_utt = 75;   // 300 ms minimum utterance
  size_t i = 0;
  while (i < n_fr) {
    while (i < n_fr && e[i] <= thresh) i++;
    if (i >= n_fr) break;
    size_t start = i;
    size_t last_active = i;
    while (i < n_fr) {
      if (e[i] > thresh) {
        last_active = i;
        i++;
      } else if (i - last_active <= min_gap) {
        i++;
      } else {
        break;
      }
    }
    if (last_active + 1 - start >= min_utt)
      out.push_back(Utterance{start * hop, (last_active + 1) * hop});
  }
  return out;
}

// Delay of `deg` within one reference utterance, searched around 0 (the
// signals are already globally aligned).  EXACT overlap-normalized
// waveform cross-correlation at step 1 over the full +-radius: coarse
// two-stage searches (envelope crude + local fine) repeatedly locked
// onto pitch-period aliases for periodic signals (a 220 Hz tone has
// correlation peaks every 36 samples, and its 4 ms log-energy envelope
// is nearly shift-invariant), while the exact normalized scan's global
// argmax is the true delay by construction.  Cost: O(radius * len),
// ~25 M MACs for a 2 s utterance at +-100 ms -- milliseconds on the
// host, irrelevant for a scoring metric.
int64_t utterance_delay(const std::vector<double>& ref,
                        const std::vector<double>& deg, const Utterance& u,
                        int64_t center, int64_t radius) {
  int64_t best = center;
  double bv = -1e300;
  for (int64_t d = center - radius; d <= center + radius; d++) {
    double acc = 0.0;
    int64_t start = std::max<int64_t>((int64_t)u.start, d);
    int64_t stop =
        std::min<int64_t>((int64_t)u.stop, (int64_t)deg.size() + d);
    if (stop - start < kFrame) continue;
    for (int64_t i2 = start; i2 < stop; i2++)
      acc += ref[(size_t)i2] * deg[(size_t)(i2 - d)];
    double v = acc / (double)(stop - start);
    if (v > bv) {
      bv = v;
      best = d;
    }
  }
  return best;
}

// Apply the time alignment, all in one read from the ORIGINAL degraded
// signal (a physical global shift followed by per-utterance re-shifts
// would discard real content at the array ends twice).  <2 utterances:
// the constant global delay `g`.  Otherwise every sample takes the
// delay of its NEAREST utterance (piecewise-constant delay field; the
// per-utterance delays are searched +-radius around g), so silence
// between utterances never reads the degraded file at an unrelated
// offset.  Returns the aligned degraded timeline (same length as ref).
std::vector<double> align_degraded(const std::vector<double>& ref,
                                   const std::vector<double>& deg,
                                   int64_t g) {
  const bool dbg = std::getenv("FCSE_PESQ_DEBUG") != nullptr;
  auto read_shifted = [&](int64_t i, int64_t d) -> double {
    int64_t j = i - d;
    return (j >= 0 && j < (int64_t)deg.size()) ? deg[(size_t)j] : 0.0;
  };
  std::vector<double> out(ref.size());
  const std::vector<Utterance> utts = segment_utterances(ref);
  if (dbg)
    std::fprintf(stderr, "pesq-debug: global %lld, %zu utterances\n",
                 (long long)g, utts.size());
  if (utts.size() < 2) {  // constant delay == global alignment
    for (size_t i = 0; i < ref.size(); i++)
      out[i] = read_shifted((int64_t)i, g);
    return out;
  }
  std::vector<int64_t> delays(utts.size());
  for (size_t k = 0; k < utts.size(); k++) {
    delays[k] = utterance_delay(ref, deg, utts[k], g, 800 /* +-100 ms */);
    if (dbg)
      std::fprintf(stderr, "pesq-debug: utt [%zu,%zu) delay %lld\n",
                   utts[k].start, utts[k].stop, (long long)delays[k]);
  }
  // Piecewise-constant delay field: every sample takes the delay of its
  // NEAREST utterance (switching at gap midpoints), so silence between
  // utterances never reads the degraded file at an unrelated offset --
  // a wrong global delay would otherwise leak utterance content into
  // reference silence, which the asymmetry factor scores as loud
  // additive distortion.
  size_t k = 0;
  for (size_t i = 0; i < out.size(); i++) {
    while (k + 1 < utts.size() &&
           i >= (utts[k].stop + utts[k + 1].start) / 2)
      k++;
    out[i] = read_shifted((int64_t)i, delays[k]);
  }
  return out;
}

// ---------------------------------------------------------------------------
// Perceptual model
// ---------------------------------------------------------------------------

struct Spectra {
  // [n_frames][kNumBands] pitch power densities, intensity units
  std::vector<std::vector<double>> ppd;
};

Spectra pitch_power_densities(const std::vector<double>& x, const BarkBands& b) {
  static std::vector<double> hann;
  if (hann.empty()) {
    hann.resize(kFrame);
    for (int i = 0; i < kFrame; i++)
      hann[i] = 0.5 * (1.0 - std::cos(2.0 * M_PI * i / (kFrame - 1)));
  }
  double wnorm = 0.0;
  for (double w : hann) wnorm += w * w;
  // scale so that the sum of band powers of a frame equals the frame's
  // mean-square power (keeps ppd in the calibrated intensity units)
  const double spec_scale = 2.0 / (wnorm * kFrame);

  Spectra s;
  if (x.size() < (size_t)kFrame) return s;
  size_t n_frames = (x.size() - kFrame) / kHop + 1;
  s.ppd.resize(n_frames, std::vector<double>(kNumBands, 0.0));
  std::vector<double> re(kFrame), im(kFrame);
  for (size_t t = 0; t < n_frames; t++) {
    for (int i = 0; i < kFrame; i++) {
      re[i] = x[t * kHop + i] * hann[i];
      im[i] = 0.0;
    }
    fft_radix2(re, im, false);
    for (int k = 0; k < kNumBands; k++) {
      double p = 0.0;
      for (int bin = b.lo_bin[k]; bin < b.hi_bin[k]; bin++)
        p += re[bin] * re[bin] + im[bin] * im[bin];
      s.ppd[t][k] = p * spec_scale;
    }
  }
  return s;
}

double total_audible(const std::vector<double>& ppd, const BarkBands& b,
                     double factor) {
  double tot = 0.0;
  for (int k = 0; k < kNumBands; k++)
    if (ppd[k] > b.thresh[k] * factor) tot += ppd[k];
  return tot;
}

// Zwicker loudness per band (sone-like units).
void loudness(const std::vector<double>& ppd, const BarkBands& b,
              std::vector<double>& out) {
  out.resize(kNumBands);
  for (int k = 0; k < kNumBands; k++) {
    double p0 = b.thresh[k];
    if (ppd[k] <= p0) {
      out[k] = 0.0;
      continue;
    }
    out[k] = kSl * std::pow(p0 / 0.5, kZwickerPow) *
             (std::pow(0.5 + 0.5 * ppd[k] / p0, kZwickerPow) - 1.0);
  }
}

// Lp norm over split-second intervals then Lq over the file.
double lpq(const std::vector<double>& d, int split, double p, double q) {
  if (d.empty()) return 0.0;
  std::vector<double> agg;
  for (size_t start = 0; start < d.size(); start += split / 2) {
    size_t stop = std::min(d.size(), start + (size_t)split);
    double acc = 0.0;
    for (size_t i = start; i < stop; i++) acc += std::pow(d[i], p);
    agg.push_back(std::pow(acc / (double)(stop - start), 1.0 / p));
    if (stop == d.size()) break;
  }
  double acc = 0.0;
  for (double v : agg) acc += std::pow(v, q);
  return std::pow(acc / (double)agg.size(), 1.0 / q);
}

}  // namespace

extern "C" {

// Narrowband P.862-structured PESQ.  ref/deg: float32 mono at 8 kHz.
// Returns score in [-0.5, 4.5]; < -100 on error.  d_out/da_out (nullable):
// raw symmetric/asymmetric disturbance indicators (for calibration tests).
double fcse_pesq_nb_ind(const float* ref_in, int64_t n_ref, const float* deg_in,
                        int64_t n_deg, double* d_out, double* da_out) {
  if (n_ref < 2 * kFrame || n_deg < 2 * kFrame) return -101.0;
  std::vector<double> ref(ref_in, ref_in + n_ref);
  std::vector<double> deg(deg_in, deg_in + n_deg);

  // 1-2. IRS-style filtering + level alignment to kLevelTarget band power.
  double bp_ref = 0.0, bp_deg = 0.0;
  irs_filter_and_band_power(ref, &bp_ref);
  irs_filter_and_band_power(deg, &bp_deg);
  if (bp_ref <= 0.0 || bp_deg <= 0.0) return -102.0;
  double s_ref = std::sqrt(kLevelTarget / bp_ref);
  double s_deg = std::sqrt(kLevelTarget / bp_deg);
  for (double& v : ref) v *= s_ref;
  for (double& v : deg) v *= s_deg;

  // 3. Time alignment: global (crude envelope + fine waveform) delay,
  // then ITU-style per-utterance re-alignment for time-VARYING delay
  // (see align_degraded above; closes the constant-delay-only gap
  // documented in earlier revisions of this header).
  int64_t crude = envelope_delay(ref, deg);
  int64_t g = fine_delay(ref, deg, crude, 320);
  deg = align_degraded(ref, deg, g);
  size_t n = std::min(ref.size(), deg.size());
  ref.resize(n);
  deg.resize(n);

  // 4. Perceptual model.
  const BarkBands bands = make_bands();
  Spectra sr_ = pitch_power_densities(ref, bands);
  Spectra sd_ = pitch_power_densities(deg, bands);
  size_t n_frames = std::min(sr_.ppd.size(), sd_.ppd.size());
  if (n_frames < 4) return -103.0;

  // Frequency compensation: per-band time-averaged ratio over
  // speech-active frames, clipped to +-20 dB, applied to the reference.
  std::vector<double> num(kNumBands, 0.0), den(kNumBands, 0.0);
  for (size_t t = 0; t < n_frames; t++) {
    if (total_audible(sr_.ppd[t], bands, 1.0) < 1e4) continue;  // silence
    for (int k = 0; k < kNumBands; k++) {
      num[k] += sd_.ppd[t][k];
      den[k] += sr_.ppd[t][k];
    }
  }
  std::vector<double> band_gain(kNumBands, 1.0);
  for (int k = 0; k < kNumBands; k++) {
    double g = (num[k] + 1e3) / (den[k] + 1e3);
    band_gain[k] = std::min(100.0, std::max(0.01, g));
  }

  // Short-term gain compensation: smoothed per-frame audible-power ratio,
  // applied to the degraded signal (slow gain tracking is not distortion).
  std::vector<double> frame_gain(n_frames, 1.0);
  double smooth = 1.0;
  for (size_t t = 0; t < n_frames; t++) {
    double pr = total_audible(sr_.ppd[t], bands, 1.0);
    double pd = total_audible(sd_.ppd[t], bands, 1.0);
    double g = (pd + 5e3) / (pr * /*freq comp'd*/ 1.0 + 5e3);
    smooth = 0.8 * smooth + 0.2 * g;
    frame_gain[t] = std::min(5.0, std::max(3e-4, smooth));
  }

  // Disturbance per frame.
  std::vector<double> d_sym(n_frames, 0.0), d_asym(n_frames, 0.0);
  std::vector<double> l_ref(kNumBands), l_deg(kNumBands), ppr(kNumBands),
      ppd_(kNumBands);
  for (size_t t = 0; t < n_frames; t++) {
    for (int k = 0; k < kNumBands; k++) {
      ppr[k] = sr_.ppd[t][k] * band_gain[k];
      ppd_[k] = sd_.ppd[t][k] / frame_gain[t];
    }
    loudness(ppr, bands, l_ref);
    loudness(ppd_, bands, l_deg);
    double acc2 = 0.0, acc1 = 0.0, wsum = 0.0;
    for (int k = 0; k < kNumBands; k++) {
      double diff = l_deg[k] - l_ref[k];
      double m = 0.25 * std::min(l_deg[k], l_ref[k]);
      double d;
      if (diff > m)
        d = diff - m;
      else if (diff < -m)
        d = diff + m;
      else
        d = 0.0;
      double w = bands.width[k];
      acc2 += w * d * d;
      // asymmetry: penalize additive (new) components only
      double h = std::pow((ppd_[k] + 50.0) / (ppr[k] + 50.0), 1.2);
      if (h < 3.0) h = 0.0;
      if (h > 12.0) h = 12.0;
      acc1 += w * std::fabs(d) * h;
      wsum += w;
    }
    d_sym[t] = std::sqrt(acc2 / wsum);
    d_asym[t] = acc1 / wsum;
    // de-weight silent frames (both), cap extreme frames
    double aud = total_audible(sr_.ppd[t], bands, 1.0);
    double hw = std::pow((aud + 1e5) / 1e7, 0.04);
    d_sym[t] = std::min(d_sym[t] / hw, 45.0);
    d_asym[t] = std::min(d_asym[t] / hw, 45.0);
  }

  double D = lpq(d_sym, (int)kSplitFrames, 6.0, 2.0);
  double DA = lpq(d_asym, (int)kSplitFrames, 6.0, 2.0);
  if (d_out) *d_out = D;
  if (da_out) *da_out = DA;

  // MOS-scale mapping, P.862 form; coefficients calibrated on anchor
  // conditions with this implementation's disturbance units (see
  // tests/test_metrics.py anchors).
  double mos = 4.5 - kCoefD * D - kCoefDA * DA;
  if (mos < -0.5) mos = -0.5;
  if (mos > 4.5) mos = 4.5;
  return mos;
}

double fcse_pesq_nb(const float* ref_in, int64_t n_ref, const float* deg_in,
                    int64_t n_deg) {
  return fcse_pesq_nb_ind(ref_in, n_ref, deg_in, n_deg, nullptr, nullptr);
}

}  // extern "C"
