"""Full-chain tests: split-complex path == complex path == oracle.

Covers the pipeline layer the reference only has in MATLAB
(WiFi_RX.m → blocks_extraction → estimators → Equalization), on both the
shipped capture and synthetic batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.datasets import synthetic
from tpu80211.pipeline import rx as rx_cpx
from tpu80211.pipeline import sc


def _c(x):
    return Cplx.from_complex(np.asarray(x), jnp.float32)


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def batch():
    key = jax.random.PRNGKey(0)
    return synthetic.generate(key, batch=8, snr_db=40.0, dtype=jnp.complex64)


def test_synthetic_roundtrip(batch):
    """synthesize_time is the exact right-inverse of extract_blocks."""
    from tpu80211.ops import extract_blocks

    pkt = synthetic.synthesize_time(batch.tx_symb)
    back = extract_blocks(pkt)
    assert _rel(back, batch.tx_symb) < 1e-5


def test_sc_front_end_matches_complex(batch):
    """Split-complex block extraction == jnp.fft path on time-domain data."""
    from tpu80211.ops import extract_blocks, preamble_fft

    pkt = np.asarray(synthetic.synthesize_time(batch.rx_symb))
    want = extract_blocks(jnp.asarray(pkt))
    got = sc.extract_blocks(_c(pkt)).to_complex()
    assert _rel(got, want) < 1e-4

    lp = np.concatenate([pkt[:, :32], pkt[:, :64], pkt[:, :64]], axis=-1)
    want_p = preamble_fft(jnp.asarray(lp))
    got_p = sc.preamble_fft(_c(lp)).to_complex()
    assert _rel(got_p, want_p) < 1e-4


def test_sc_estimators_match_complex_models(batch, capture):
    """sc.* estimators agree with models.* on the shipped capture."""
    from tpu80211.models import lt_ls, ps_interp, ps_mmse

    tx_pre, rx_pre = capture.tx_preamble_fft, capture.rx_preamble_fft
    txb, rxb = capture.tx_symb, capture.rx_symb

    got_lt = sc.lt_ls(_c(tx_pre), _c(rx_pre)).to_complex()
    want_lt = lt_ls(jnp.asarray(tx_pre), jnp.asarray(rx_pre))
    assert _rel(got_lt, want_lt) < 1e-5

    for kind in ("linear", "cubic", "sinc", "spline"):
        got = sc.ps_interp(_c(txb), _c(rxb), kind).to_complex()
        want = ps_interp(jnp.asarray(txb), jnp.asarray(rxb), kind)
        assert _rel(got, want) < 1e-4, kind

    got_m = sc.ps_mmse_sm(
        _c(txb), _c(rxb), jnp.asarray([capture.ow2], jnp.float32)[0] * jnp.ones(()),
        sc.lt_ls(_c(tx_pre), _c(rx_pre)),
    ).to_complex()
    want_m = ps_mmse(
        jnp.asarray(txb), jnp.asarray(rxb), capture.ow2,
        lt_ls(jnp.asarray(tx_pre), jnp.asarray(rx_pre)),
    )
    # MMSE conditioning is σ²-limited; f32 vs f64 tolerance is looser
    assert _rel(got_m, want_m) < 5e-3


def test_rx_chain_full_vs_freq(batch):
    """Time-domain entry == frequency-domain entry on synthetic frames."""
    pkt_tx = synthetic.synthesize_time(batch.tx_symb)
    pkt_rx = synthetic.synthesize_time(batch.rx_symb)
    # build a preamble: 32-sample CP + two identical LTS repeats
    lts_t = synthetic.synthesize_time(
        jnp.broadcast_to(batch.tx_preamble_fft[:, None, :], batch.tx_symb.shape)
    )[:, C.N_CP : C.N_CP + C.N_FFT]
    tx_lp = jnp.concatenate([lts_t[:, :32], lts_t, lts_t], axis=-1)
    rx_lts = synthetic.synthesize_time(
        jnp.broadcast_to(batch.rx_preamble_fft[:, None, :], batch.tx_symb.shape)
    )[:, C.N_CP : C.N_CP + C.N_FFT]
    rx_lp = jnp.concatenate([rx_lts[:, :32], rx_lts, rx_lts], axis=-1)

    out_t = sc.rx_chain(_c(pkt_tx), _c(pkt_rx), _c(tx_lp), _c(rx_lp))
    # identical repeats ⇒ ow2 estimate 0 ⇒ MMSE degenerate; compare the
    # ow2-independent fields only
    out_f = sc.rx_chain_freq(
        sc.preamble_fft(_c(tx_lp)),
        sc.preamble_fft(_c(rx_lp)),
        sc.extract_blocks(_c(pkt_tx)),
        sc.extract_blocks(_c(pkt_rx)),
        out_t.ow2,
    )
    assert _rel(out_t.h_lt.to_complex(), out_f.h_lt.to_complex()) < 1e-6
    assert _rel(out_t.h_linear.to_complex(), out_f.h_linear.to_complex()) < 1e-6


def test_rx_chain_complex_pipeline(batch, capture):
    """Complex-dtype pipeline runs end-to-end and matches per-part models."""
    out = rx_cpx.rx_chain_freq(
        jnp.asarray(capture.tx_preamble_fft),
        jnp.asarray(capture.rx_preamble_fft),
        jnp.asarray(capture.tx_symb),
        jnp.asarray(capture.rx_symb),
        capture.ow2,
    )
    from tpu80211.models import lt_ls

    want = lt_ls(
        jnp.asarray(capture.tx_preamble_fft), jnp.asarray(capture.rx_preamble_fft)
    )
    assert _rel(out.h_lt, want) == 0.0
    assert out.eq.shape == (C.N_BLOCKS, C.N_SC)
    # DC column forced to zero
    assert np.abs(np.asarray(out.eq)[:, C.DC_IDX]).max() == 0.0


def test_mmse_estimate_quality(batch):
    """On synthetic frames the MMSE estimate tracks the true channel."""
    out = sc.rx_chain_freq(
        _c(batch.tx_preamble_fft),
        _c(batch.rx_preamble_fft),
        _c(batch.tx_symb),
        _c(batch.rx_symb),
        batch.ow2,
    )
    h = out.h_mmse.to_complex()
    h_true = np.asarray(batch.h_true)
    mask = ~C.PILOT_MASK.copy()
    mask[C.DC_IDX] = False
    err = np.abs(h - h_true)[:, mask]
    rel = err.mean() / np.abs(h_true).mean()
    assert rel < 0.15, rel


def test_bf16_storage_chain(batch):
    """bf16-storage chain tracks the f32 chain within bf16 precision —
    the halved-HBM-traffic production mode."""
    txp = _c(batch.tx_preamble_fft).astype(jnp.bfloat16)
    rxp = _c(batch.rx_preamble_fft).astype(jnp.bfloat16)
    txb = _c(batch.tx_symb).astype(jnp.bfloat16)
    rxb = _c(batch.rx_symb).astype(jnp.bfloat16)
    out16 = sc.rx_chain_freq(txp, rxp, txb, rxb, batch.ow2)
    out32 = sc.rx_chain_freq(
        _c(batch.tx_preamble_fft), _c(batch.rx_preamble_fft),
        _c(batch.tx_symb), _c(batch.rx_symb), batch.ow2,
    )
    assert out16.eq.dtype == jnp.bfloat16
    for name, tol in (("h_lt", 3e-2), ("h_linear", 3e-2), ("h_mmse", 6e-2)):
        got = getattr(out16, name).to_complex()
        want = getattr(out32, name).to_complex()
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < tol, (name, rel)
