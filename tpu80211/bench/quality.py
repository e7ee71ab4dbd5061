"""Estimator quality benchmark: NMSE / EVM / BER versus SNR.

The reference publishes no accuracy numbers at all — its accuracy record
is four eyeballed CFR plot PNGs plus a saved MATLAB workspace
(SURVEY.md §6).  This module produces the quantitative version: for each
SNR point it generates a batch of synthetic frames with known ground-truth
CFR (datasets/synthetic.py), runs all six estimators, and reports

  * CFR NMSE (dB) per estimator against the true channel, and
  * post-equalization EVM and QPSK pseudo-BER per estimator (each
    estimator used as the PS side of the blended equalizer,
    WiFi_Equalization.m:6-7).

Runs with complex dtypes (the golden path, pipeline/rx.py's ops); the
split-complex production path is quality-gated against this same math by
tests/test_fused_chain.py and tests/test_chain_parity.py.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.datasets import synthetic
from tpu80211.models import lt_ls, ps_interp, ps_mmse
from tpu80211.ops import equalize
from tpu80211.utils import metrics

KINDS = ("linear", "cubic", "sinc", "spline", "wiener")
DEFAULT_SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0)


def quality_point(snr_db: float, batch: int = 512, seed: int = 0,
                  channel_model: str | None = None,
                  modulation: str = "qpsk") -> dict:
    """One SNR point: {estimator: {nmse_db, evm_rms, ber}} + metadata.
    ``channel_model`` ∈ {None, 'A'..'E'} (ops/channel.py — WiFi_RX.m:6);
    ``modulation`` ∈ {"qpsk", "qam16", "qam64"} (Gray-coded BER)."""
    fb = synthetic.generate(
        jax.random.PRNGKey(seed), batch, snr_db=snr_db, dtype=jnp.complex64,
        channel_model=channel_model, modulation=modulation,
    )
    txb, rxb = fb.tx_symb, fb.rx_symb
    h_lt = lt_ls(fb.tx_preamble_fft, fb.rx_preamble_fft)

    ests = {"lt_ls": h_lt}
    for kind in KINDS:
        # the Wiener estimator's prior matches the channel model + SNR
        # being generated (wiener_matrix_for — the receiver would know
        # its operating environment); other kinds ignore the kwargs
        kw = ({"channel_model": channel_model, "snr_db": snr_db}
              if kind == "wiener" else {})
        ests[f"ps_{kind}"] = ps_interp(txb, rxb, kind, **kw)
    ests["ps_mmse"] = ps_mmse(txb, rxb, fb.ow2, h_lt)

    m = {"qpsk": 4, "qam16": 16, "qam64": 64}[modulation]
    row = {"snr_db": float(snr_db), "batch": int(batch),
           "channel_model": channel_model, "modulation": modulation,
           "estimators": {}}
    for name, h in ests.items():
        eq = equalize(rxb, h_lt, h)
        row["estimators"][name] = {
            "nmse_db": round(metrics.cfr_nmse_db(h, fb.h_true), 2),
            "evm_rms": round(metrics.evm_rms(eq, txb), 4),
            "ber": round(metrics.qam_ber(eq, txb, m), 5),
        }
    return row


def quality_sweep(
    snrs: Sequence[float] = DEFAULT_SNRS, batch: int = 512, seed: int = 0,
    channel_model: str | None = None, modulation: str = "qpsk",
) -> list[dict]:
    return [quality_point(s, batch=batch, seed=seed + i,
                          channel_model=channel_model, modulation=modulation)
            for i, s in enumerate(snrs)]


def _lts_repeat_time(spec: jnp.ndarray) -> jnp.ndarray:
    """(…, 53) spectrum → one 64-sample time-domain LTS repeat."""
    *lead, nsc = spec.shape
    spec64 = jnp.zeros((*lead, C.N_FFT), spec.dtype)
    spec64 = spec64.at[..., :nsc].set(spec)
    spec64 = jnp.roll(spec64, -C.FFT_SHIFT, axis=-1)
    return jnp.fft.ifft(spec64, axis=-1)


def quality_point_storage(snr_db: float, batch: int = 256, seed: int = 0,
                          dtype=None) -> dict:
    """Same metrics through the split-complex production chain
    (pipeline/sc.rx_chain) at a given storage dtype — the configuration
    bench.py times.

    ``dtype``: jnp.bfloat16 (the shipped bench default) or jnp.float32.
    The rx preamble is synthesized with *independent* noise per LTS
    repeat so the in-chain σ² estimate (WiFi_RX.m:31) is realistic.
    Post-eq metrics use the chain's PS-Linear blended equalizer
    (WiFi_RX.m:60); NMSE is reported for every estimator incl. Wiener.
    """
    from tpu80211.cplx import Cplx
    from tpu80211.pipeline import sc

    if dtype is None:
        dtype = jnp.bfloat16
    k = jax.random.PRNGKey(seed)
    fb = synthetic.generate(k, batch, snr_db=snr_db, dtype=jnp.complex64)

    pkt_tx = np.asarray(synthetic.synthesize_time(fb.tx_symb))
    pkt_rx = np.asarray(synthetic.synthesize_time(fb.rx_symb))
    tx_lp = np.asarray(synthetic.synthesize_preamble_time(fb.tx_preamble_fft))

    # rx preamble: channel-filtered LTS + independent noise per repeat
    sigma2 = 10.0 ** (-snr_db / 10.0)
    k1r, k1i, k2r, k2i = jax.random.split(jax.random.PRNGKey(seed + 9999), 4)
    clean = jnp.asarray(fb.tx_preamble_fft) * jnp.asarray(fb.h_true)

    def rep(kr, ki):
        n = (jax.random.normal(kr, clean.shape) +
             1j * jax.random.normal(ki, clean.shape)) * np.sqrt(sigma2 / 2.0)
        return _lts_repeat_time(clean + n.astype(clean.dtype))

    t1 = rep(k1r, k1i)
    t2 = rep(k2r, k2i)
    rx_lp = np.asarray(jnp.concatenate([t1[..., -32:], t1, t2], axis=-1))

    def c(x):
        return Cplx.from_complex(x, dtype)

    out = sc.rx_chain(c(pkt_tx), c(pkt_rx), c(tx_lp), c(rx_lp))

    row = {
        "snr_db": float(snr_db), "batch": int(batch),
        "path": "split_complex", "dtype": str(np.dtype(dtype).name),
        "estimators": {},
    }
    for name in ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline",
                 "h_wiener", "h_mmse"):
        h = jnp.asarray(getattr(out, name).to_complex())
        key = {"h_lt": "lt_ls"}.get(name, "ps_" + name[2:])
        row["estimators"][key] = {
            "nmse_db": round(metrics.cfr_nmse_db(h, fb.h_true), 2),
        }
    eq = jnp.asarray(out.eq.to_complex())
    row["eq_linear_blend"] = {
        "evm_rms": round(metrics.evm_rms(eq, fb.tx_symb), 4),
        "ber": round(metrics.qpsk_ber(eq, fb.tx_symb), 5),
    }
    return row


def quality_sweep_storage(
    snrs: Sequence[float] = DEFAULT_SNRS, batch: int = 256, seed: int = 0,
    dtype=None,
) -> list[dict]:
    return [quality_point_storage(s, batch=batch, seed=seed + i, dtype=dtype)
            for i, s in enumerate(snrs)]


def plot_quality(rows: list[dict], out_path: str,
                 storage_rows: list[dict] | None = None) -> str:
    """NMSE-vs-SNR curves per estimator → PNG (the quantitative successor
    of the reference's Real_Part/Imag_Part.png accuracy record).
    ``storage_rows`` (quality_sweep_storage) overlays the production
    chain's storage-dtype series as dashed NMSE curves — the f32-vs-bf16
    delta record."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(rows[0]["estimators"].keys())
    snrs = [r["snr_db"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    for name in names:
        ax1.plot(snrs, [r["estimators"][name]["nmse_db"] for r in rows],
                 marker="o", label=name)
        ax2.semilogy(
            snrs,
            [max(r["estimators"][name]["ber"], 1e-6) for r in rows],
            marker="o", label=name,
        )
    if storage_rows:
        fsnrs = [r["snr_db"] for r in storage_rows]
        dt = storage_rows[0]["dtype"]
        for name in storage_rows[0]["estimators"]:
            ax1.plot(
                fsnrs,
                [r["estimators"][name]["nmse_db"] for r in storage_rows],
                linestyle="--", marker="x", alpha=0.7,
                label=f"{name} [{dt}]",
            )
        ax2.semilogy(
            fsnrs,
            [max(r["eq_linear_blend"]["ber"], 1e-6) for r in storage_rows],
            linestyle="--", marker="x", color="k",
            label=f"eq blend [{dt}]",
        )
    ax1.legend(fontsize=6)
    ax1.set_xlabel("SNR (dB)")
    ax1.set_ylabel("CFR NMSE (dB)")
    ax1.set_title("Channel-estimation error")
    ax1.grid(True, alpha=0.3)
    ax2.set_xlabel("SNR (dB)")
    ax2.set_ylabel("QPSK BER (floor 1e-6)")
    ax2.set_title("Post-equalization BER (blended equalizer)")
    ax2.grid(True, alpha=0.3)
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
