"""Channel-model registry (ops/channel.py): the reference's WiFi_RX.m:6
``channel_model = 'A'  % Values: A, B, C, D, E`` parameter, implemented
as ETSI BRAN exponential power-delay profiles for the synthetic
generators (the reference itself contains no channel code — the capture
was generated offline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211.ops import channel


def test_registry_complete_and_ordered():
    assert set(channel.CHANNEL_MODELS) == {"A", "B", "C", "D", "E"}
    # ETSI rms spreads in ns
    assert channel.CHANNEL_MODELS["A"] == 50e-9
    assert channel.CHANNEL_MODELS["E"] == 250e-9


def test_pdp_normalized_and_decaying():
    for m in (None, "A", "B", "C", "D", "E"):
        p = channel.pdp(m)
        assert abs(p.sum() - 1.0) < 1e-12, m
        assert (np.diff(p) < 0).all(), m
        assert p.size <= 16  # never exceeds the cyclic prefix


def test_longer_spread_more_taps():
    assert channel.n_taps_for("E") > channel.n_taps_for("A")
    assert channel.n_taps_for(None) == channel.LEGACY_N_TAPS


def test_generate_accepts_models_and_selectivity_orders():
    """Frequency selectivity (CFR variation across bins) grows with the
    delay spread: model E channels vary more than model A channels."""
    from tpu80211.datasets import synthetic

    def sel(model):
        fb = synthetic.generate(jax.random.PRNGKey(0), 256, snr_db=40.0,
                                channel_model=model)
        h = np.asarray(fb.h_true)
        # mean per-frame variance of |H| across subcarriers
        return float(np.mean(np.var(np.abs(h), axis=-1)))

    sa, se = sel("A"), sel("E")
    assert se > 1.5 * sa, (sa, se)


@pytest.mark.parametrize("model", ["A", "E"])
def test_gen_chain_accepts_models(capture, model):
    """The generative chain (pipeline/lane.gen_chain) produces consistent
    statistics per model."""
    from tpu80211.cplx import Cplx
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.lane import gen_chain

    txs, tpre = tx_spectra(
        Cplx.from_complex(capture.tx_packet),
        Cplx.from_complex(capture.tx_lptot),
    )
    out = gen_chain(jnp.int32(3), 128, txs, tpre, snr_db=35.0,
                          channel_model=model)
    h = out["h_true"].to_complex()
    assert abs(float(np.mean(np.abs(h) ** 2)) - 1.0) < 0.2
    e = out["h_lt"].to_complex()
    nmse = 10 * np.log10(np.sum(np.abs(e - h) ** 2) / np.sum(np.abs(h) ** 2))
    assert nmse < -12.0, (model, nmse)


def test_device_stream_accepts_model():
    from tpu80211.pipeline import stream

    step, s0 = stream.make_device_stream_step(128, snr_db=35.0,
                                              channel_model="C")
    summary, _, _ = step(0, s0)
    assert float(summary["h_lt_nmse"]) < 0.1
