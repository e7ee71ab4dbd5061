"""Packet detection + timing synchronization from a raw sample stream.

The reference declares ``threshold = 4e-3; % Threshold for signal
detection`` (WiFi_RX.m:7) but contains no detection code — its chain
starts from a pre-extracted packet.  This module implements the stage
that parameter promises, with static shapes, cumulative-sum sliding windows
and convolutions:

  * **coarse detection** — Schmidl&Cox-style lag-64 normalized
    autocorrelation over the repeated LTS halves:
    M(d) = |Σ_{k<64} r[d+k]·conj(r[d+64+k])|² / (Σ_{k<64} |r[d+64+k]|²)²,
    computed for every offset with two cumulative sums (O(N), no loops);
    a packet is declared where M first exceeds ``threshold`` (the
    plateau over the CP + repeats).  With ``stride`` > 1 the metric is
    evaluated every ``stride`` offsets from stride-sample block sums —
    M(stride·i) exactly, not an approximation; the LTS plateau spans
    CP+128 ≈ 160 samples, so any stride ≤ 64 grid still lands on it;
  * **fine timing** — matched filter against the known 64-sample LTS
    (4 real convolutions per complex correlation, `lax.conv`), searched
    in a window around the coarse hit; the LTS repeats give two peaks
    64 samples apart — the earlier is rep-1, so the long-preamble start
    is peak − 32 (its cyclic prefix).

All functions are batched over leading dims and jit-friendly.  The
lane-major (NS, B) entries (``detect_and_align``, ``extract_lane_major``,
``place_streams``) serve the raw receiver and its stream generator,
whose sample planes keep the stream axis last.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx

LAG = C.N_FFT          # 64 — LTS repeat period
WIN = C.N_FFT          # correlation window length
DEFAULT_THRESHOLD = 0.5  # on the normalized metric M ∈ [0, ~1]


def _window_sums(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Sliding sums of length ``w`` along the last axis via cumsum:
    out[d] = Σ_{k<w} x[d+k], shape (..., N-w+1)."""
    c = jnp.cumsum(x, axis=-1)
    zero = jnp.zeros_like(c[..., :1])
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., w:] - c[..., :-w]


def _upcast(x: Cplx) -> Cplx:
    """Narrow sample words (bf16, int8) → f32; f64 stays f64.  The
    sliding sums run over thousands of samples and need the width."""
    return x.astype(jnp.promote_types(x.dtype, jnp.float32))


def autocorr_metric(x: Cplx, stride: int = 1) -> jnp.ndarray:
    """Normalized lag-64 autocorrelation metric M(d), (..., N-128+1), or
    M(stride·i) for i < (N-64)//stride - 64//stride + 1 when ``stride``
    (a power-of-2 divisor of 64) is > 1.

    M ≈ 1 over the LTS plateau (signal repeats with period 64), ≈ 0 in
    noise.  Division is guarded for all-zero windows."""
    x = _upcast(x)
    a = Cplx(x.re[..., :-LAG], x.im[..., :-LAG])
    b = Cplx(x.re[..., LAG:], x.im[..., LAG:])
    prod = a * b.conj()                             # x[d]·conj(x[d+64])
    # normalize by BOTH window energies (Cauchy-Schwarz ⇒ M ≤ 1 always;
    # a single-window normalizer lets energy fluctuations in data/noise
    # push M past any threshold)
    terms = (prod.re, prod.im, a.abs2(), b.abs2())
    win = WIN
    if stride > 1:
        assert WIN % stride == 0, stride
        nblk = a.shape[-1] // stride
        terms = tuple(
            t[..., : nblk * stride].reshape(*t.shape[:-1], nblk, stride)
            .sum(axis=-1) for t in terms)
        win = WIN // stride
    p_re, p_im, e1, e2 = (_window_sums(t, win) for t in terms)
    return (p_re * p_re + p_im * p_im) / jnp.maximum(e1 * e2, 1e-30)


def matched_filter(x: Cplx, ref: Cplx) -> jnp.ndarray:
    """|cross-correlation| of the stream with a known reference,
    (..., N-len(ref)+1).  4 real convolutions at full f32 precision."""
    x = _upcast(x)
    n_ref = ref.shape[-1]
    *lead, n = x.shape
    flat = (-1, 1, n)
    ref = ref.astype(x.dtype)

    def conv(sig, ker):
        # lax.conv is cross-correlation (NN convention, no kernel flip) —
        # exactly corr[d] = Σ_k sig[d+k]·ker[k]
        out = jax.lax.conv_general_dilated(
            sig.reshape(flat),
            ker.reshape(1, 1, n_ref),
            window_strides=(1,), padding="VALID",
            precision=jax.lax.Precision.HIGHEST,
        )
        return out.reshape(*lead, -1)

    # corr[d] = Σ x[d+k]·conj(ref[k])
    cr = conv(x.re, ref.re) + conv(x.im, ref.im)
    ci = conv(x.im, ref.re) - conv(x.re, ref.im)
    return jnp.sqrt(cr * cr + ci * ci)


def detect_packet(
    x: Cplx,                     # (..., N) raw sample stream
    lts_ref: Cplx,               # (64,) known time-domain LTS symbol
    threshold: float = DEFAULT_THRESHOLD,
    search: int = 192,
    advance: int = 4,
    stride: int = 1,
) -> dict:
    """Detect the packet and return its long-preamble start index.

    Returns dict of (...,)-shaped arrays:
      * ``detected`` — bool, the metric crossed ``threshold`` anywhere;
      * ``coarse``   — first offset where M(d) > threshold;
      * ``start``    — fine lptot start (rep-1 matched-filter peak − 32
        − ``advance``);
      * ``metric``   — the peak M value (quality indicator).

    ``search``: half-width of the fine-search window around the coarse
    hit (the plateau spans CP+128 ≈ 160 samples).  ``advance``: timing
    advance in samples — the matched filter peaks at the channel's bulk
    delay, and extracting LATE costs inter-symbol interference (the FFT
    window borrows samples of the next block) while extracting EARLY by
    up to the cyclic-prefix margin is a pure per-bin phase ramp the
    estimators absorb; biasing a few samples early is the standard
    receiver practice.  ``stride``: coarse-metric decimation (see the
    module docstring); the fine timing stays full-resolution, with its
    window anchored one stride before the decimated hit and widened by
    one stride, so ``start`` does not depend on it while ``coarse`` is
    stride-granular."""
    m = autocorr_metric(x, stride)                  # (..., Nm)
    nm = m.shape[-1]
    above = m > threshold
    detected = jnp.any(above, axis=-1)
    # first crossing: argmax of the boolean (ties → first True)
    coarse = jnp.argmax(above, axis=-1)
    if stride > 1:
        # the true first crossing can precede the decimated hit by up to
        # stride-1 samples
        coarse = jnp.maximum(coarse * stride - stride, 0)
        search = search + stride

    mf = matched_filter(x, lts_ref)                 # (..., Nf)
    # the LTS appears at rep1 and rep2 = rep1 + 64: score each candidate
    # rep1 position by the SUM of both repeat peaks — unambiguous where a
    # single-peak argmax must guess which repeat it found (sidelobes of a
    # dispersive channel can reach ~0.85 of the main peak).  A 5-sample
    # smoothing integrates energy a dispersive channel spreads across
    # neighboring lags before scoring.
    mf_s = _window_sums(mf, 5)                      # centered at d+2
    pair = mf_s[..., :-LAG] + mf_s[..., LAG:]       # (..., Nf-68)
    np_ = pair.shape[-1]
    idx = jnp.arange(np_)
    lo = coarse[..., None]
    mask = (idx >= lo) & (idx < lo + 2 * search)
    rep1 = jnp.argmax(jnp.where(mask, pair, 0.0), axis=-1) + 2
    start = rep1 - 32 - advance                     # lptot = [32-CP|rep|rep]

    idx_m = jnp.arange(nm) * stride
    mask_m = (idx_m >= lo) & (idx_m < lo + 2 * search)
    peak_m = jnp.max(jnp.where(mask_m, m, 0.0), axis=-1)
    # no crossing ⇒ argmax over an all-False mask would yield plausible
    # garbage indices; force -1 so an ungated caller fails loudly
    # (extract_packet clips -1 to 0 — still gate on `detected`)
    return {
        "detected": detected,
        "coarse": jnp.where(detected, coarse, -1),
        "start": jnp.where(detected, start, -1),
        "metric": peak_m,
    }


def extract_packet(x: Cplx, start: jnp.ndarray) -> tuple[Cplx, Cplx]:
    """Slice (lptot (…,160), packet (…,1200)) at per-row ``start`` from a
    (B, N) stream (dynamic_slice under vmap; jit-friendly)."""
    total = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES

    def one(row_re, row_im, s):
        s = jnp.clip(s, 0, row_re.shape[-1] - total)
        fr = jax.lax.dynamic_slice(row_re, (s,), (total,))
        fi = jax.lax.dynamic_slice(row_im, (s,), (total,))
        return fr, fi

    fr, fi = jax.vmap(one)(x.re, x.im, start)
    lp = Cplx(fr[..., : C.PREAMBLE_SAMPLES], fi[..., : C.PREAMBLE_SAMPLES])
    pkt = Cplx(fr[..., C.PREAMBLE_SAMPLES :], fi[..., C.PREAMBLE_SAMPLES :])
    return lp, pkt


def lts_time_symbol(tx_lptot) -> Cplx:
    """The known 64-sample LTS symbol from a (…,160) transmit preamble
    (one clean repeat — the matched-filter reference)."""
    if isinstance(tx_lptot, Cplx):
        return Cplx(tx_lptot.re[..., -C.N_FFT :], tx_lptot.im[..., -C.N_FFT :])
    arr = np.asarray(tx_lptot)
    return Cplx.from_complex(arr[..., -C.N_FFT :])


def extract_lane_major(x: Cplx, start: jnp.ndarray) -> tuple[Cplx, Cplx]:
    """Slice (lptot (160, B), packet (1200, B)) at per-stream ``start``
    from lane-major (NS, B) streams — one gather along the sample axis."""
    total = C.PREAMBLE_SAMPLES + C.PACKET_SAMPLES
    ns = x.shape[0]
    s = jnp.clip(start, 0, ns - total)
    rows = s[None, :] + jnp.arange(total, dtype=start.dtype)[:, None]
    fr = jnp.take_along_axis(x.re, rows, axis=0)
    fi = jnp.take_along_axis(x.im, rows, axis=0)
    lp = Cplx(fr[: C.PREAMBLE_SAMPLES], fi[: C.PREAMBLE_SAMPLES])
    pkt = Cplx(fr[C.PREAMBLE_SAMPLES :], fi[C.PREAMBLE_SAMPLES :])
    return lp, pkt


def detect_and_align(
    x: Cplx,                      # (NS, B) lane-major raw streams
    lts_ref: Cplx,
    threshold: float = DEFAULT_THRESHOLD,
    search: int = 192,
    advance: int = 4,
    stride: int = 1,
) -> tuple[dict, Cplx, Cplx]:
    """Detection + per-stream extraction for lane-major streams.

    Returns (detection dict of (B,) rows, lptot (160, B), packet
    (1200, B)); the aligned planes keep the stream's storage dtype.
    Undetected streams are aligned at offset 0 and flagged — gate on
    ``detected``."""
    res = detect_packet(Cplx(x.re.T, x.im.T), lts_ref, threshold=threshold,
                        search=search, advance=advance, stride=stride)
    start = jnp.maximum(jnp.asarray(res["start"], jnp.int32), 0)
    lp, pkt = extract_lane_major(x, start)
    return res, lp, pkt


def place_streams(sig: Cplx, noise: Cplx, offs: jnp.ndarray) -> Cplx:
    """x[r, l] = sig[(r − offs[l]) mod ns, l] + noise[r, l] — per-stream
    frame placement for the raw-stream generator, lane-major (ns, B),
    as one gather along the sample axis."""
    ns = sig.shape[0]
    offs = jnp.asarray(offs, jnp.int32)
    rows = jnp.mod(jnp.arange(ns, dtype=jnp.int32)[:, None] - offs[None, :],
                   ns)
    return Cplx(jnp.take_along_axis(sig.re, rows, axis=0) + noise.re,
                jnp.take_along_axis(sig.im, rows, axis=0) + noise.im)
