// Native streaming data engine: synthetic 802.11 frame generation.
//
// Native counterpart of the host-side data path.  The reference bakes
// its one captured frame into the binary (inputs.h) and replays it across
// MPI frame groups (main_mpi.c:62-93); this framework streams >=1e5 fresh
// frames per second through the chip, so frame *generation* on the host
// becomes a real throughput term in pipeline/stream.py.  This library is
// the C++ producer: it fills caller-owned f32 split-complex planes
// (the device storage format, tpu80211/cplx.py) directly — no Python-side
// arithmetic, no intermediate complex128 arrays — multithreaded over
// frames with std::thread.
//
// Semantics mirror tpu80211/datasets/synthetic.py::generate:
//   * 8-tap exponential power-delay-profile channel (rms spread 2.0
//     samples), unit total power — channel-model-'A' shaped (WiFi_RX.m:6);
//   * QPSK data on the 48 data subcarriers, +1 pilots at 5/19/33/47,
//     DC (26) empty, per OFDM block; a caller-supplied ±1 LTS preamble;
//   * AWGN at the requested SNR; optional per-block CFO phase rotation
//     (the dominant CFO term of the shipped capture, WiFi_RX.m:9);
//   * optionally synthesizes the time-domain view — the exact right-
//     inverse of block extraction (zero-pad 53→64 shifted bins, inverse
//     DFT-64, prepend the 16-sample CP; preamble as CP32 + 2 LTS repeats,
//     WiFi_RX.m:19-29) — so the time-domain chain (pipeline/sc.py) can
//     be fed natively.
//
// Determinism: frame i (global index frame0+i) depends only on
// (seed, frame0+i) via a splitmix64-derived stream, so results are
// identical for any thread count and any batch partitioning — the
// checkpoint/resume property pipeline/stream.py relies on.
//
// Distributions are the same families as the JAX generator (Gaussian
// taps/noise, Bernoulli bits) but the RNG differs (splitmix64 vs
// threefry), so individual frames differ between engines; tests gate the
// *statistics* and the estimator behavior, not bitwise identity.

#include <cmath>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kNSc = 53;          // SAMPUTIL (utils.h:12)
constexpr int kNBlocks = 15;      // OFDMBLK (utils.h:13)
constexpr int kNFft = 64;         // K (WiFi_RX.m:11)
constexpr int kNCp = 16;          // cyclic prefix
constexpr int kSampPerBlock = kNFft + kNCp;   // 80
constexpr int kPacket = kSampPerBlock * kNBlocks;  // 1200
constexpr int kPreamble = 160;    // CP32 + 2×64 LTS repeats
constexpr int kFftShift = 26;     // circshift amount (WiFi_RX.m:22-29)
constexpr int kDc = 26;
constexpr int kPilots[4] = {5, 19, 33, 47};
constexpr int kNTaps = 8;
constexpr double kRmsSpread = 2.0;
constexpr double kPi = 3.14159265358979323846;

// -- splitmix64: per-frame deterministic stream ------------------------------
inline uint64_t sm64_next(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed, uint64_t frame) {
    // mix seed and frame index so nearby frames decorrelate
    s = seed ^ 0xA02BDBF7BB3C0A7ull;
    s ^= sm64_next(s) + frame * 0x9E3779B97F4A7C15ull;
    (void)sm64_next(s);
  }
  // uniform in (0, 1]
  double uniform() {
    return static_cast<double>((sm64_next(s) >> 11) + 1) *
           (1.0 / 9007199254740992.0);
  }
  uint64_t bits() { return sm64_next(s); }
  // standard normal pair (Box–Muller)
  void normal2(double& a, double& b) {
    double u1 = uniform(), u2 = uniform();
    double r = std::sqrt(-2.0 * std::log(u1));
    a = r * std::cos(2.0 * kPi * u2);
    b = r * std::sin(2.0 * kPi * u2);
  }
};

// -- precomputed constant tables ---------------------------------------------
// CFR matrix: h[k] = sum_n taps[n] * Wc[n][k], Wc[n][k] = exp(-2πi·n·g(k)/64),
// g(k) = (k − 26) mod 64 — the shifted 53-bin grid (synthetic.py::_cfr_from_taps).
double g_wc_re[kNTaps][kNSc], g_wc_im[kNTaps][kNSc];
// PDP tap scales sqrt(p_n / 2), p ∝ exp(−n/rms), Σp = 1.
double g_tap_scale[kNTaps];
// Inverse block DFT: x[t] = (1/64) Σ_j X[j]·exp(+2πi·t·g(j)/64) — the exact
// right-inverse of ops/blocks.py::extract_blocks (synthetic.py::synthesize_time).
double g_inv_re[kNFft][kNSc], g_inv_im[kNFft][kNSc];
std::once_flag g_tables_once;

void init_tables() {
  double psum = 0.0, p[kNTaps];
  for (int n = 0; n < kNTaps; ++n) {
    p[n] = std::exp(-n / kRmsSpread);
    psum += p[n];
  }
  for (int n = 0; n < kNTaps; ++n)
    g_tap_scale[n] = std::sqrt(p[n] / psum / 2.0);
  for (int k = 0; k < kNSc; ++k) {
    int gk = ((k - kFftShift) % kNFft + kNFft) % kNFft;
    for (int n = 0; n < kNTaps; ++n) {
      double ang = -2.0 * kPi * n * gk / kNFft;
      g_wc_re[n][k] = std::cos(ang);
      g_wc_im[n][k] = std::sin(ang);
    }
    for (int t = 0; t < kNFft; ++t) {
      double ang = 2.0 * kPi * t * gk / kNFft;
      g_inv_re[t][k] = std::cos(ang) / kNFft;
      g_inv_im[t][k] = std::sin(ang) / kNFft;
    }
  }
}

// 53-bin spectrum → 64-sample time block (inverse shifted DFT).
void inv_dft(const double* xr, const double* xi, double* tr, double* ti) {
  for (int t = 0; t < kNFft; ++t) {
    double ar = 0.0, ai = 0.0;
    for (int j = 0; j < kNSc; ++j) {
      ar += g_inv_re[t][j] * xr[j] - g_inv_im[t][j] * xi[j];
      ai += g_inv_re[t][j] * xi[j] + g_inv_im[t][j] * xr[j];
    }
    tr[t] = ar;
    ti[t] = ai;
  }
}

struct Args {
  uint64_t seed, frame0;
  int64_t batch;
  double sigma2, nsc;      // noise power and per-plane std
  double cfo_rad;          // per-block phase increment
  const float* lts_re;     // (53,) real ±1 preamble spectrum
  // frequency-domain outputs (always written)
  float *tpre_r, *tpre_i, *rpre_r, *rpre_i;   // (B,53)
  float *tx_r, *tx_i, *rx_r, *rx_i;           // (B,15,53)
  float *ow2, *h_r, *h_i;                      // (B,), (B,53)
  // optional time-domain outputs (nullptr → skip)
  float *tpkt_r, *tpkt_i, *rpkt_r, *rpkt_i;   // (B,1200)
  float *tlp_r, *tlp_i, *rlp_r, *rlp_i;       // (B,160)
};

void synth_packet(const double* br, const double* bi, float* out_r,
                  float* out_i, int block) {
  // one 53-bin block spectrum → 80 samples (CP ‖ 64-pt block) at offset
  double tr[kNFft], ti[kNFft];
  inv_dft(br, bi, tr, ti);
  float* pr = out_r + block * kSampPerBlock;
  float* pi_ = out_i + block * kSampPerBlock;
  for (int t = 0; t < kNCp; ++t) {
    pr[t] = static_cast<float>(tr[kNFft - kNCp + t]);
    pi_[t] = static_cast<float>(ti[kNFft - kNCp + t]);
  }
  for (int t = 0; t < kNFft; ++t) {
    pr[kNCp + t] = static_cast<float>(tr[t]);
    pi_[kNCp + t] = static_cast<float>(ti[t]);
  }
}

void gen_range(const Args& a, int64_t lo, int64_t hi) {
  const double inv_sqrt2 = 1.0 / std::sqrt(2.0);
  for (int64_t f = lo; f < hi; ++f) {
    Rng rng(a.seed, a.frame0 + static_cast<uint64_t>(f));

    // channel taps → CFR
    double hr[kNSc] = {0}, hi_[kNSc] = {0};
    for (int n = 0; n < kNTaps; ++n) {
      double gr, gi;
      rng.normal2(gr, gi);
      gr *= g_tap_scale[n];
      gi *= g_tap_scale[n];
      for (int k = 0; k < kNSc; ++k) {
        hr[k] += gr * g_wc_re[n][k] - gi * g_wc_im[n][k];
        hi_[k] += gr * g_wc_im[n][k] + gi * g_wc_re[n][k];
      }
    }
    float* hrow_r = a.h_r + f * kNSc;
    float* hrow_i = a.h_i + f * kNSc;
    for (int k = 0; k < kNSc; ++k) {
      hrow_r[k] = static_cast<float>(hr[k]);
      hrow_i[k] = static_cast<float>(hi_[k]);
    }

    // preambles: tx = LTS, rx = LTS·h + noise
    float* tpr = a.tpre_r + f * kNSc;
    float* tpi = a.tpre_i + f * kNSc;
    float* rpr = a.rpre_r + f * kNSc;
    float* rpi = a.rpre_i + f * kNSc;
    double pre_r[kNSc], pre_i[kNSc], rxp_r[kNSc], rxp_i[kNSc];
    for (int k = 0; k < kNSc; ++k) {
      double lt = static_cast<double>(a.lts_re[k]);
      pre_r[k] = lt;
      pre_i[k] = 0.0;
      double n1, n2;
      rng.normal2(n1, n2);
      rxp_r[k] = lt * hr[k] + a.nsc * n1;
      rxp_i[k] = lt * hi_[k] + a.nsc * n2;
      tpr[k] = static_cast<float>(pre_r[k]);
      tpi[k] = 0.0f;
      rpr[k] = static_cast<float>(rxp_r[k]);
      rpi[k] = static_cast<float>(rxp_i[k]);
    }

    // data blocks
    float* txr = a.tx_r + f * kNBlocks * kNSc;
    float* txi = a.tx_i + f * kNBlocks * kNSc;
    float* rxr = a.rx_r + f * kNBlocks * kNSc;
    float* rxi = a.rx_i + f * kNBlocks * kNSc;
    for (int b = 0; b < kNBlocks; ++b) {
      double rot_r = 1.0, rot_i = 0.0;
      if (a.cfo_rad != 0.0) {
        rot_r = std::cos(a.cfo_rad * b);
        rot_i = std::sin(a.cfo_rad * b);
      }
      double tb_r[kNSc], tb_i[kNSc], rb_r[kNSc], rb_i[kNSc];
      uint64_t bitbuf = 0;
      int nbits = 0;
      for (int k = 0; k < kNSc; ++k) {
        double tr_, ti_;
        if (k == kDc) {
          tr_ = ti_ = 0.0;
        } else if (k == kPilots[0] || k == kPilots[1] || k == kPilots[2] ||
                   k == kPilots[3]) {
          tr_ = 1.0;
          ti_ = 0.0;
        } else {
          if (nbits < 2) {
            bitbuf = rng.bits();
            nbits = 64;
          }
          tr_ = ((bitbuf & 1) ? 1.0 : -1.0) * inv_sqrt2;
          ti_ = ((bitbuf & 2) ? 1.0 : -1.0) * inv_sqrt2;
          bitbuf >>= 2;
          nbits -= 2;
        }
        double n1, n2;
        rng.normal2(n1, n2);
        double yr = tr_ * hr[k] - ti_ * hi_[k] + a.nsc * n1;
        double yi = tr_ * hi_[k] + ti_ * hr[k] + a.nsc * n2;
        // per-block CFO rotation (synthetic.py::generate fo path)
        double zr = yr * rot_r - yi * rot_i;
        double zi = yr * rot_i + yi * rot_r;
        tb_r[k] = tr_;
        tb_i[k] = ti_;
        rb_r[k] = zr;
        rb_i[k] = zi;
        int o = b * kNSc + k;
        txr[o] = static_cast<float>(tr_);
        txi[o] = static_cast<float>(ti_);
        rxr[o] = static_cast<float>(zr);
        rxi[o] = static_cast<float>(zi);
      }
      if (a.tpkt_r) {
        synth_packet(tb_r, tb_i, a.tpkt_r + f * kPacket, a.tpkt_i + f * kPacket, b);
        synth_packet(rb_r, rb_i, a.rpkt_r + f * kPacket, a.rpkt_i + f * kPacket, b);
      }
    }

    a.ow2[f] = static_cast<float>(a.sigma2);

    if (a.tlp_r) {
      // 160-sample long preamble: CP32 + two LTS repeats (WiFi_RX.m:19-29)
      double tr[kNFft], ti[kNFft];
      auto emit = [&](const double* sr, const double* si, float* or_,
                      float* oi) {
        inv_dft(sr, si, tr, ti);
        float* pr = or_ + f * kPreamble;
        float* pi_ = oi + f * kPreamble;
        for (int t = 0; t < 32; ++t) {
          pr[t] = static_cast<float>(tr[32 + t]);
          pi_[t] = static_cast<float>(ti[32 + t]);
        }
        for (int rep = 0; rep < 2; ++rep)
          for (int t = 0; t < kNFft; ++t) {
            pr[32 + rep * kNFft + t] = static_cast<float>(tr[t]);
            pi_[32 + rep * kNFft + t] = static_cast<float>(ti[t]);
          }
      };
      emit(pre_r, pre_i, a.tlp_r, a.tlp_i);
      emit(rxp_r, rxp_i, a.rlp_r, a.rlp_i);
    }
  }
}

}  // namespace

extern "C" {

// Fill a batch of synthetic frames.  All output pointers are caller-owned
// f32 planes in batch-major layout.  Time-domain pointers may ALL be null
// (frequency-domain only) or ALL non-null.  n_threads <= 0 → hardware
// concurrency.  Deterministic in (seed, frame0+i) regardless of threading.
void gen_frames_f32(
    uint64_t seed, uint64_t frame0, int64_t batch, double snr_db,
    double cfo_rad_per_block, int n_threads, const float* lts_re,
    float* tpre_r, float* tpre_i, float* rpre_r, float* rpre_i,
    float* tx_r, float* tx_i, float* rx_r, float* rx_i,
    float* ow2, float* h_r, float* h_i,
    float* tpkt_r, float* tpkt_i, float* rpkt_r, float* rpkt_i,
    float* tlp_r, float* tlp_i, float* rlp_r, float* rlp_i) {
  std::call_once(g_tables_once, init_tables);
  Args a;
  a.seed = seed;
  a.frame0 = frame0;
  a.batch = batch;
  a.sigma2 = std::pow(10.0, -snr_db / 10.0);
  a.nsc = std::sqrt(a.sigma2 / 2.0);
  a.cfo_rad = cfo_rad_per_block;
  a.lts_re = lts_re;
  a.tpre_r = tpre_r; a.tpre_i = tpre_i; a.rpre_r = rpre_r; a.rpre_i = rpre_i;
  a.tx_r = tx_r; a.tx_i = tx_i; a.rx_r = rx_r; a.rx_i = rx_i;
  a.ow2 = ow2; a.h_r = h_r; a.h_i = h_i;
  a.tpkt_r = tpkt_r; a.tpkt_i = tpkt_i; a.rpkt_r = rpkt_r; a.rpkt_i = rpkt_i;
  a.tlp_r = tlp_r; a.tlp_i = tlp_i; a.rlp_r = rlp_r; a.rlp_i = rlp_i;

  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > batch) nt = static_cast<int>(batch);
  if (nt == 1) {
    gen_range(a, 0, batch);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  int64_t chunk = (batch + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < batch ? lo + chunk : batch;
    if (lo >= hi) break;
    pool.emplace_back([&a, lo, hi] { gen_range(a, lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
