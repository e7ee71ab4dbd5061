// oracle.cpp — native 80-bit sequential parity oracle for tpu80211.
//
// A from-scratch C++17 re-implementation of the *behavior* of the
// reference's sequential estimator chain (main.c:66-212 + utils.c kernels),
// written to the spec in SURVEY.md §2.2/§2.5 — NOT a copy of the reference
// sources.  It exists so the JAX paths can be parity-gated against a
// freshly compiled native binary at the same `long double` (x87 80-bit)
// precision the reference uses, including the reference's documented
// quirks when `c_parity` is set:
//   - LT-LS "conjugate" is the real scalar Re−Im (main.c:69-70);
//   - cubic divided differences all use delta=14 (main.c:113-118);
//   - MMSE: real 'hermitian' Re−Im transpose (utils.c:3-7), the addition
//     bug making Ryy = 2σ²I (utils.c:111-121), X4 carrying only the 4
//     pilot entries (main.c:166-178), block-0-only processing (main.c:16);
//   - the 53×53 inverse computed by cofactor/adjugate expansion with the
//     rank-1 condensation determinant (utils.c:141-170, 543-569), kept
//     algorithmically identical so rounding behaviour matches.
//
// API: extern "C", split re/im `double` planes (the ctypes boundary);
// internal arithmetic is std::complex<long double>.

#include <complex>
#include <cmath>
#include <cstring>
#include <vector>

using cld = std::complex<long double>;
using ld = long double;

namespace {

constexpr int NSC = 53;          // used subcarriers (SAMPUTIL)
constexpr int NBLK = 15;         // OFDM blocks per frame (OFDMBLK)
constexpr int PIL[4] = {5, 19, 33, 47};  // 0-based pilot indices
constexpr int DC = 26;
constexpr ld DELTA = 14.0L;

struct Mat {
  int n;
  std::vector<cld> a;  // row-major n×n
  explicit Mat(int n_) : n(n_), a(size_t(n_) * n_) {}
  cld& at(int r, int c) { return a[size_t(r) * n + c]; }
  const cld& at(int r, int c) const { return a[size_t(r) * n + c]; }
};

// determinant by "condensation": rank-1 elimination into an (n-1)² minor,
// recursing down to 2×2 — the O(n³)-per-determinant scheme the reference
// uses for every cofactor (utils.c:543-569 behavioral spec).  The divided
// form (sub = A[1:,1:] − (A[1:,0]/p)·A[0,1:], det = p·det(sub)) keeps
// entries bounded; the multiply-then-rescale form overflows long double
// by n≈50.
cld det_condense(const Mat& m) {
  int n = m.n;
  if (n == 1) return m.at(0, 0);
  if (n == 2) return m.at(0, 0) * m.at(1, 1) - m.at(0, 1) * m.at(1, 0);
  Mat sub(n - 1);
  cld p = m.at(0, 0);
  for (int r = 1; r < n; ++r) {
    cld f = m.at(r, 0) / p;
    for (int c = 1; c < n; ++c)
      sub.at(r - 1, c - 1) = m.at(r, c) - f * m.at(0, c);
  }
  return p * det_condense(sub);
}

// minor(A, drop_row, drop_col)
Mat minor_of(const Mat& m, int dr, int dc_) {
  Mat out(m.n - 1);
  for (int r = 0, ro = 0; r < m.n; ++r) {
    if (r == dr) continue;
    for (int c = 0, co = 0; c < m.n; ++c) {
      if (c == dc_) continue;
      out.at(ro, co) = m.at(r, c);
      ++co;
    }
    ++ro;
  }
  return out;
}

// adjugate/cofactor inverse: Y[i][j] = det⁻¹·(−1)^{i+j}·det(minor(A,j,i))
// (utils.c:141-170 behavioral spec).  O(n²) determinants — the reference's
// hot spot, reproduced verbatim-in-spirit for parity timing/numerics.
Mat inverse_cofactor(const Mat& m) {
  int n = m.n;
  Mat out(n);
  cld d = det_condense(m);
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) {
      cld cof = det_condense(minor_of(m, j, i));
      ld sign = ((i + j) % 2 == 0) ? 1.0L : -1.0L;
      out.at(i, j) = sign * cof / d;
    }
  return out;
}

// Gauss-Jordan inverse with partial pivoting — the numerically sane
// alternative used for MATH/MATLAB-mode checks.
Mat inverse_gauss(const Mat& m) {
  int n = m.n;
  std::vector<std::vector<cld>> aug(n, std::vector<cld>(2 * n));
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < n; ++c) aug[r][c] = m.at(r, c);
    aug[r][n + r] = 1.0L;
  }
  for (int col = 0; col < n; ++col) {
    int piv = col;
    ld best = std::abs(aug[col][col]);
    for (int r = col + 1; r < n; ++r)
      if (std::abs(aug[r][col]) > best) { best = std::abs(aug[r][col]); piv = r; }
    if (piv != col) std::swap(aug[piv], aug[col]);
    cld p = aug[col][col];
    for (int c = 0; c < 2 * n; ++c) aug[col][c] /= p;
    for (int r = 0; r < n; ++r) {
      if (r == col) continue;
      cld f = aug[r][col];
      if (f == cld(0.0L)) continue;
      for (int c = 0; c < 2 * n; ++c) aug[r][c] -= f * aug[col][c];
    }
  }
  Mat out(n);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) out.at(r, c) = aug[r][n + c];
  return out;
}

Mat dft53() {
  Mat f(NSC);
  for (int t = 0; t < NSC; ++t)
    for (int k = 0; k < NSC; ++k) {
      ld ang = -2.0L * M_PIl * (ld)t * (ld)k / (ld)NSC;
      f.at(t, k) = cld(std::cos(ang), std::sin(ang));
    }
  return f;
}

Mat matmul(const Mat& a, const Mat& b) {
  int n = a.n;
  Mat out(n);
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < n; ++k) {
      cld av = a.at(i, k);
      if (av == cld(0.0L)) continue;
      for (int j = 0; j < n; ++j) out.at(i, j) += av * b.at(k, j);
    }
  return out;
}

std::vector<cld> matvec(const Mat& a, const std::vector<cld>& x) {
  std::vector<cld> y(a.n);
  for (int i = 0; i < a.n; ++i) {
    cld acc = 0.0L;
    for (int j = 0; j < a.n; ++j) acc += a.at(i, j) * x[j];
    y[i] = acc;
  }
  return y;
}

void unpack(const double* re, const double* im, int n, std::vector<cld>& out) {
  out.resize(n);
  for (int i = 0; i < n; ++i) out[i] = cld((ld)re[i], (ld)im[i]);
}

void pack(const std::vector<cld>& in, double* re, double* im) {
  for (size_t i = 0; i < in.size(); ++i) {
    re[i] = (double)in[i].real();
    im[i] = (double)in[i].imag();
  }
}

ld sinc_ld(ld x) {
  if (x == 0.0L) return 1.0L;
  ld px = M_PIl * x;
  return std::sin(px) / px;
}

}  // namespace

extern "C" {

// LT-LS on the 53-bin preamble spectra.  c_parity: conj := Re−Im real
// scalar (main.c:69-70); otherwise true conjugate.  DC forced 0.
void est_lt_ls(const double* tx_re, const double* tx_im,
               const double* rx_re, const double* rx_im,
               double* h_re, double* h_im, int c_parity) {
  std::vector<cld> tx, rx, h(NSC);
  unpack(tx_re, tx_im, NSC, tx);
  unpack(rx_re, rx_im, NSC, rx);
  for (int i = 0; i < NSC; ++i) {
    if (i == DC) { h[i] = 0.0L; continue; }
    cld conj_v = c_parity ? cld(tx[i].real() - tx[i].imag(), 0.0L)
                          : std::conj(tx[i]);
    h[i] = (conj_v * rx[i]) / (conj_v * tx[i]);
  }
  pack(h, h_re, h_im);
}

// Pilot-subcarrier LS + interpolation for one block.
// kind: 0=linear, 1=cubic, 2=sinc.  c_parity only changes cubic
// denominators (all DELTA, main.c:113-118) — linear/sinc agree in both.
void est_ps_block(const double* tx_re, const double* tx_im,
                  const double* rx_re, const double* rx_im,
                  double* h_re, double* h_im, int kind, int c_parity) {
  std::vector<cld> tx, rx, h(NSC);
  unpack(tx_re, tx_im, NSC, tx);
  unpack(rx_re, rx_im, NSC, rx);
  cld hp[4];
  for (int p = 0; p < 4; ++p) hp[p] = rx[PIL[p]] / tx[PIL[p]];

  if (kind == 0) {  // piecewise linear; last segment reuses slope 2→3
    for (int k = 0; k < NSC; ++k) {
      int s = (k < PIL[1]) ? 0 : (k < PIL[2]) ? 1 : 2;
      ld a = (ld)(k - PIL[s]) / DELTA;
      h[k] = hp[s] + (hp[s + 1] - hp[s]) * a;
    }
  } else if (kind == 1) {  // Newton divided differences
    ld d012 = c_parity ? DELTA : 2 * DELTA;
    ld d123 = c_parity ? DELTA : 2 * DELTA;
    ld d0123 = c_parity ? DELTA : 3 * DELTA;
    cld f01 = (hp[1] - hp[0]) / DELTA;
    cld f12 = (hp[2] - hp[1]) / DELTA;
    cld f23 = (hp[3] - hp[2]) / DELTA;
    cld f012 = (f12 - f01) / d012;
    cld f123 = (f23 - f12) / d123;
    cld f0123 = (f123 - f012) / d0123;
    for (int k = 0; k < NSC; ++k) {
      ld x1 = k - PIL[0], x2 = k - PIL[1], x3 = k - PIL[2];
      h[k] = hp[0] + f01 * x1 + f012 * x1 * x2 + f0123 * x1 * x2 * x3;
    }
  } else {  // sinc, all deltas 14
    for (int k = 0; k < NSC; ++k) {
      cld acc = 0.0L;
      for (int p = 0; p < 4; ++p)
        acc += hp[p] * sinc_ld((ld)(k - PIL[p]) / DELTA);
      h[k] = acc;
    }
  }
  pack(h, h_re, h_im);
}

// PS-MMSE on one block.
// mode: 0 = MATH (true cross-covariance X4ᴴ, Gauss inverse),
//       1 = MATLAB (X4 slip in Rhy, Gauss inverse),
//       2 = C_PARITY (all §2.5 quirks + cofactor inverse).
// use_cofactor: force the cofactor/adjugate inverse in modes 0/1 too
// (for timing the reference's computational shape).
void est_ps_mmse_block(const double* tx_re, const double* tx_im,
                       const double* rx_re, const double* rx_im,
                       const double* hlt_re, const double* hlt_im,
                       double ow2, double* h_re, double* h_im,
                       int mode, int use_cofactor) {
  std::vector<cld> tx, rx, hlt;
  unpack(tx_re, tx_im, NSC, tx);
  unpack(rx_re, rx_im, NSC, rx);
  unpack(hlt_re, hlt_im, NSC, hlt);
  Mat f = dft53();

  if (mode == 2) {
    // C-parity chain: invF by cofactor, real 'hermitian', X4 = 4 pilot
    // entries, Ryy = 2σ²I (addition bug), block-level only.
    Mat invF = use_cofactor ? inverse_cofactor(f) : inverse_gauss(f);
    std::vector<cld> t1 = matvec(invF, hlt);
    // hermitian(F): res[c][r] = Re F[r][c] − Im F[r][c] (real)
    Mat fh(NSC);
    for (int r = 0; r < NSC; ++r)
      for (int c = 0; c < NSC; ++c)
        fh.at(c, r) = cld(f.at(r, c).real() - f.at(r, c).imag(), 0.0L);
    // w = hermitian of column t1 (a real row): Re − Im
    std::vector<cld> w(NSC);
    for (int i = 0; i < NSC; ++i)
      w[i] = cld(t1[i].real() - t1[i].imag(), 0.0L);
    // w2 = (w @ fh) ⊙ x4diag   (x4 carries only the 4 pilot tx entries)
    std::vector<cld> wfh(NSC, 0.0L);
    for (int j = 0; j < NSC; ++j) {
      cld acc = 0.0L;
      for (int i = 0; i < NSC; ++i) acc += w[i] * fh.at(i, j);
      wfh[j] = acc;
    }
    std::vector<cld> x4d(NSC, 0.0L);
    for (int p = 0; p < 4; ++p) x4d[PIL[p]] = tx[PIL[p]];
    // s = Σ w2·rx / (2σ²);   H = F·t1 · s
    cld s = 0.0L;
    for (int j = 0; j < NSC; ++j) s += wfh[j] * x4d[j] * rx[j];
    s /= (2.0L * (ld)ow2);
    std::vector<cld> ft1 = matvec(f, t1);
    std::vector<cld> h(NSC);
    for (int i = 0; i < NSC; ++i) h[i] = ft1[i] * s;
    pack(h, h_re, h_im);
    return;
  }

  // MATH / MATLAB: v = F·ifft(hlt) = hlt; Rhh rank-1; dense Ryy solve.
  // Build Ryy = X4·F·Rhh·Fᴴ·X4ᴴ + σ²I = u·uᴴ + σ²I with u = tx⊙hlt.
  std::vector<cld> u(NSC), upp(NSC);
  for (int i = 0; i < NSC; ++i) {
    u[i] = tx[i] * hlt[i];
    upp[i] = (mode == 1) ? std::conj(tx[i]) * hlt[i]  // MATLAB X4 slip
                         : u[i];                       // MATH: X4ᴴ
  }
  Mat ryy(NSC);
  for (int i = 0; i < NSC; ++i) {
    for (int j = 0; j < NSC; ++j) ryy.at(i, j) = u[i] * std::conj(u[j]);
    ryy.at(i, i) += (ld)ow2;
  }
  Mat inv = use_cofactor ? inverse_cofactor(ryy) : inverse_gauss(ryy);
  std::vector<cld> z = matvec(inv, rx);
  cld s = 0.0L;
  for (int i = 0; i < NSC; ++i) s += std::conj(upp[i]) * z[i];
  std::vector<cld> h(NSC);
  for (int i = 0; i < NSC; ++i) h[i] = hlt[i] * s;
  pack(h, h_re, h_im);
}

// Frame-level PS estimators: average the first `avg_blocks` block
// estimates (WiFi_channel_estimation_PS_Linear.m:23).  tx/rx are
// (NBLK, NSC) row-major planes.
void est_ps_frame(const double* tx_re, const double* tx_im,
                  const double* rx_re, const double* rx_im,
                  double* h_re, double* h_im, int kind, int c_parity,
                  int avg_blocks) {
  std::vector<cld> acc(NSC, 0.0L);
  int nb = c_parity ? 1 : avg_blocks;
  std::vector<double> br(NSC), bi(NSC);
  for (int b = 0; b < nb; ++b) {
    est_ps_block(tx_re + b * NSC, tx_im + b * NSC, rx_re + b * NSC,
                 rx_im + b * NSC, br.data(), bi.data(), kind, c_parity);
    for (int i = 0; i < NSC; ++i) acc[i] += cld((ld)br[i], (ld)bi[i]);
  }
  for (int i = 0; i < NSC; ++i) acc[i] /= (ld)nb;
  pack(acc, h_re, h_im);
}

// Equalizer (WiFi_Equalization.m:3-8): blended CFR, skip DC.
// rx: (NBLK, NSC); out same shape.
void equalize(const double* rx_re, const double* rx_im,
              const double* hlt_re, const double* hlt_im,
              const double* hps_re, const double* hps_im,
              double* out_re, double* out_im) {
  std::vector<cld> hlt, hps, rx;
  unpack(hlt_re, hlt_im, NSC, hlt);
  unpack(hps_re, hps_im, NSC, hps);
  for (int b = 0; b < NBLK; ++b) {
    unpack(rx_re + b * NSC, rx_im + b * NSC, NSC, rx);
    ld i1 = (ld)(b + 1);
    for (int k = 0; k < NSC; ++k) {
      cld out = 0.0L;
      if (k != DC) {
        cld hu = ((ld)NBLK - i1) / (ld)NBLK * hlt[k] + i1 / (ld)NBLK * hps[k];
        out = rx[k] / hu;
      }
      out_re[b * NSC + k] = (double)out.real();
      out_im[b * NSC + k] = (double)out.imag();
    }
  }
}

// Determinants — the reference carries three algorithms (utils.c):
// textbook Laplace expansion (CalcDeterminant, utils.c:462 — O(n!)),
// rank-1 condensation (determinant_impl_rec, utils.c:543 — what every
// inverse uses), and in-place Gaussian elimination with pivot swaps
// (determinant_impl, utils.c:572).  Its own commented-out self-check
// compares them on a random 53×53 matrix (main_openmp.c:216-245); our
// test suite runs that comparison for real.
// method: 0=condensation, 1=elimination, 2=Laplace (n ≤ 10 enforced).
void determinant_n(const double* a_re, const double* a_im, int n, int method,
                   double* out_re, double* out_im) {
  Mat m(n);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      m.at(r, c) = cld((ld)a_re[r * n + c], (ld)a_im[r * n + c]);
  cld d;
  if (method == 0) {
    d = det_condense(m);
  } else if (method == 1) {
    // Gaussian elimination with partial pivoting; det = ±Π diag
    ld sign = 1.0L;
    for (int col = 0; col < n; ++col) {
      int piv = col;
      ld best = std::abs(m.at(col, col));
      for (int r = col + 1; r < n; ++r)
        if (std::abs(m.at(r, col)) > best) { best = std::abs(m.at(r, col)); piv = r; }
      if (piv != col) {
        for (int c = 0; c < n; ++c) std::swap(m.at(piv, c), m.at(col, c));
        sign = -sign;
      }
      cld p = m.at(col, col);
      if (p == cld(0.0L)) { d = 0.0L; goto done_elim; }
      for (int r = col + 1; r < n; ++r) {
        cld f = m.at(r, col) / p;
        for (int c = col; c < n; ++c) m.at(r, c) -= f * m.at(col, c);
      }
    }
    d = sign;
    for (int i = 0; i < n; ++i) d *= m.at(i, i);
  done_elim:;
  } else {
    // Laplace cofactor expansion along row 0 — exponential; small n only
    if (n > 10) { *out_re = 0.0; *out_im = 0.0; return; }
    struct Rec {
      static cld det(const Mat& m) {
        int n = m.n;
        if (n == 1) return m.at(0, 0);
        cld acc = 0.0L;
        for (int j = 0; j < n; ++j) {
          cld cof = det(minor_of(m, 0, j));
          acc += ((j % 2 == 0) ? 1.0L : -1.0L) * m.at(0, j) * cof;
        }
        return acc;
      }
    };
    d = Rec::det(m);
  }
  *out_re = (double)d.real();
  *out_im = (double)d.imag();
}

// n×n inverse entry point (kernel-level parity/timing; n=53 in production).
void inverse_n(const double* a_re, const double* a_im, double* y_re,
               double* y_im, int n, int use_cofactor) {
  Mat m(n);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      m.at(r, c) = cld((ld)a_re[r * n + c], (ld)a_im[r * n + c]);
  Mat inv = use_cofactor ? inverse_cofactor(m) : inverse_gauss(m);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) {
      y_re[r * n + c] = (double)inv.at(r, c).real();
      y_im[r * n + c] = (double)inv.at(r, c).imag();
    }
}

}  // extern "C"
