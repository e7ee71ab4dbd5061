"""Lane-major entries of the RX chain: the frame axis is LAST.

A receiver that writes its ADC stream sample-by-sample across many
frames naturally produces (samples, frames) planes, so these entries take
packets (1200, B) and preambles (160, B) and return estimates (53, B),
equalized symbols (15, 53, B) and per-frame rows (B,).  The math is the
batch-major chain of pipeline/sc.py (``extract_blocks`` →
``rx_chain_freq`` → ``equalize``); the layout change happens at the
boundary.

Entries:

* ``rx_chain_lane_major`` — per-frame transmit packets;
* ``rx_chain_txconst`` — every frame carries one known transmit packet,
  passed as its precomputed spectra (``tx_spectra``), so only the rx
  side is read per frame;
* ``gen_chain`` — frequency-domain frames synthesized on device through
  a fresh channel per frame, then the chain (the device-resident stream's
  generator; pipeline/stream.py).

Output dict: ``h_lt``, ``h_linear``, ``h_cubic``, ``h_sinc``,
``h_spline``, ``h_wiener``, ``h_mmse`` (53, B) Cplx f32; ``eq``
(15, 53, B) Cplx in the storage dtype (bf16 for int8 input); ``ow2``,
``cfo``, ``checksum`` (B,).  ``checksum`` is a per-frame sum over every
output, so reading (B,) values fences the whole computation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.ops import cfo as cfo_ops
from tpu80211.pipeline import sc

OUT_NAMES = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline",
             "h_wiener", "h_mmse")
# diagnostics that serving mode drops (the served estimates are h_wiener,
# h_mmse, eq, ow2, cfo, checksum)
SERVE_DROP = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline")
# width of the generative stream's per-lane summary rows (gen_chain)
SUM_LANES = 128


def _bm(x: Cplx) -> Cplx:
    """Lane-major (n, B) → batch-major (B, n)."""
    return Cplx(x.re.T, x.im.T)


def tx_spectra(tx_pkt: Cplx, tx_lp: Cplx) -> tuple[Cplx, Cplx]:
    """Precompute the tx-constant spectra for `rx_chain_txconst`.

    tx_pkt: (1200,) one transmit packet; tx_lp: (160,) its long preamble.
    Returns (block spectra (53, 15) Cplx f32, preamble spectrum (53, 1)
    Cplx f32) — what the per-frame chain computes from the same packet."""
    blocks = sc.extract_blocks(tx_pkt.astype(jnp.float32))      # (15, 53)
    pre = sc.preamble_fft(tx_lp.astype(jnp.float32))            # (53,)
    return Cplx(blocks.re.T, blocks.im.T), Cplx(pre.re[:, None],
                                                pre.im[:, None])


def quantize_i8(x: Cplx, lsb=None):
    """Quantize split-complex samples to int8 ADC words.

    ``lsb`` (the ADC step) defaults to maxabs/127 computed over the
    batch.  Returns (Cplx int8, lsb f32 scalar)."""
    if lsb is None:
        m = jnp.maximum(jnp.max(jnp.abs(x.re)), jnp.max(jnp.abs(x.im)))
        lsb = m.astype(jnp.float32) / 127.0
    q = Cplx(
        jnp.clip(jnp.round(x.re / lsb), -127, 127).astype(jnp.int8),
        jnp.clip(jnp.round(x.im / lsb), -127, 127).astype(jnp.int8),
    )
    return q, lsb


def _rx_front(rx_pkt: Cplx, rx_lp: Cplx, scale, sync: bool):
    """Batch-major rx front end: (optional CFO correction,) spectra and
    σ², all scaled by ``scale`` (applied to the f32 spectra — the DFT is
    linear — so bf16 samples reach the DFT as they are stored)."""
    if sync:
        rx_pkt, rx_lp, eps_cfo = cfo_ops.correct_cfo(rx_pkt, rx_lp)
    else:
        eps_cfo = jnp.zeros(rx_pkt.shape[:1], jnp.float32)
    rx_pre = sc.preamble_fft(rx_lp) * scale
    rx_blocks = sc.extract_blocks(rx_pkt) * scale
    ow2 = sc.noise_power(rx_lp) * (scale * scale)
    return rx_pre, rx_blocks, ow2, eps_cfo


def _pack(out: sc.RxOutputs, eq_dtype, cfo) -> dict:
    """Batch-major chain outputs → the lane-major output dict."""
    res = {name: _bm(getattr(out, name)) for name in OUT_NAMES}
    eq = out.eq
    res["eq"] = Cplx(jnp.transpose(eq.re, (1, 2, 0)).astype(eq_dtype),
                     jnp.transpose(eq.im, (1, 2, 0)).astype(eq_dtype))
    res["ow2"] = out.ow2
    res["cfo"] = cfo
    chk = out.ow2 + sum(jnp.sum(res[n].re + res[n].im, axis=0)
                        for n in OUT_NAMES)
    res["checksum"] = chk + jnp.sum(
        res["eq"].re.astype(jnp.float32) + res["eq"].im.astype(jnp.float32),
        axis=(0, 1))
    return res


def _chain(tx_pre, tx_blocks, rx_pkt, rx_lp, scale, sync, equalize_with,
           wiener_model, wiener_snr_db):
    """Shared body: batch-major tx spectra + lane-major rx planes."""
    eq_dtype = rx_pkt.dtype
    rx_pre, rx_blocks, ow2, eps_cfo = _rx_front(_bm(rx_pkt), _bm(rx_lp),
                                                scale, sync)
    out = sc.rx_chain_freq(tx_pre, rx_pre, tx_blocks, rx_blocks, ow2,
                           equalize_with=equalize_with,
                           wiener_model=wiener_model,
                           wiener_snr_db=wiener_snr_db)
    if sync:
        out = out._replace(eq=cfo_ops.cpe_correct(out.eq, tx_blocks))
    return _pack(out, eq_dtype, eps_cfo)


@functools.partial(jax.jit, static_argnames=("sync", "wiener_model",
                                             "wiener_snr_db"))
def _lane_major(tx_pkt, rx_pkt, tx_lp, rx_lp, eps, sync=False,
                wiener_model=None, wiener_snr_db=None):
    scale = 1.0 + jnp.asarray(eps, jnp.float32)
    tx_pre = sc.preamble_fft(_bm(tx_lp)) * scale
    tx_blocks = sc.extract_blocks(_bm(tx_pkt)) * scale
    return _chain(tx_pre, tx_blocks, rx_pkt, rx_lp, scale, sync,
                  "h_linear", wiener_model, wiener_snr_db)


def rx_chain_lane_major(tx_pkt: Cplx, rx_pkt: Cplx, tx_lp: Cplx,
                        rx_lp: Cplx, eps=0.0, sync: bool = False,
                        wiener_model: str | None = None,
                        wiener_snr_db: float | None = None) -> dict:
    """Lane-major chain with per-frame transmit packets: packets
    (1200, B), preambles (160, B), any B.  Returns the module's output
    dict.

    ``eps``: every input is scaled by (1+eps) — the benchmark's
    serialization perturbation (eps=0.0 multiplies by exactly 1.0).
    ``sync``: Moose CFO derotation + pilot CPE correction
    (= sc.rx_chain(sync=True)); ``cfo`` is then the estimate, else 0."""
    return _lane_major(tx_pkt, rx_pkt, tx_lp, rx_lp, eps, sync=sync,
                       wiener_model=wiener_model,
                       wiener_snr_db=wiener_snr_db)


@functools.partial(jax.jit, static_argnames=("sync", "wiener_model",
                                             "wiener_snr_db",
                                             "equalize_with"))
def _txconst(txs, tpre, rx_pkt, rx_lp, eps, lsb, sync=False,
             wiener_model=None, wiener_snr_db=None,
             equalize_with="h_linear"):
    if rx_pkt.dtype == jnp.int8:
        # every int8 word is exact in bf16, so the chain runs on bf16
        # storage with the LSB folded into the scale
        rx_pkt = rx_pkt.astype(jnp.bfloat16)
        rx_lp = rx_lp.astype(jnp.bfloat16)
    b = rx_pkt.shape[-1]
    scale = (1.0 + jnp.asarray(eps, jnp.float32)) * jnp.asarray(
        lsb, jnp.float32)
    tx_pre = Cplx(jnp.broadcast_to(tpre.re[:, 0], (b, C.N_SC)),
                  jnp.broadcast_to(tpre.im[:, 0], (b, C.N_SC)))
    shape = (b, C.N_BLOCKS, C.N_SC)
    tx_blocks = Cplx(
        jnp.broadcast_to(txs.re[:, :C.N_BLOCKS].T[None], shape),
        jnp.broadcast_to(txs.im[:, :C.N_BLOCKS].T[None], shape))
    return _chain(tx_pre, tx_blocks, rx_pkt, rx_lp, scale, sync,
                  equalize_with, wiener_model, wiener_snr_db)


def rx_chain_txconst(txs: Cplx, tpre: Cplx, rx_pkt: Cplx, rx_lp: Cplx,
                     eps=0.0, sync: bool = False, serve: bool = False,
                     wiener_model: str | None = None,
                     wiener_snr_db: float | None = None,
                     lsb=1.0, equalize_with: str = "h_linear") -> dict:
    """tx-constant lane-major chain: the whole stream shares one known
    transmit packet, passed as precomputed spectra (see `tx_spectra`).

    txs: (53, 15) block spectra; tpre: (53, 1); rx_pkt: (1200, B);
    rx_lp: (160, B).  With eps≠0 only the rx side is perturbed.

    ``serve=True`` is the serving configuration: the five diagnostic
    planes (`SERVE_DROP`) map to None and only the served outputs are
    returned; under an enclosing jit their writes are dead and removed.
    The checksum still covers every estimator.

    ``lsb``: ADC scale for int8 ingestion — rx_pkt/rx_lp may carry int8
    sample words (`quantize_i8`); ``eq`` then comes out bf16."""
    out = _txconst(txs, tpre, rx_pkt, rx_lp, eps, lsb, sync=sync,
                   wiener_model=wiener_model, wiener_snr_db=wiener_snr_db,
                   equalize_with=equalize_with)
    if serve:
        out.update({k: None for k in SERVE_DROP})
    return out


@functools.partial(jax.jit, static_argnames=("batch", "snr_db", "eq_dtype",
                                             "channel_model", "stream_sums"))
def gen_chain(seed, batch: int, txs: Cplx, tpre: Cplx, snr_db: float = 20.0,
              eq_dtype=jnp.bfloat16, channel_model: str | None = None,
              stream_sums: bool = False) -> dict:
    """Generate ``batch`` tx-constant frames in the frequency domain and
    run the chain on them.

    Per frame: a fresh CFR from the ``channel_model`` power-delay profile
    (datasets/synthetic_sc.channel_cfr); rx block spectra txs[:, b]·H +
    N_b with per-bin noise variance 64·σ_t²; two noisy preamble repeats
    averaged as WiFi_RX.m:19-29, and σ̂² from their difference with the
    64/53 band-limitation factor (noise exists only on the 53 used bins)
    — E[σ̂²] = σ_t².  The Wiener prior matches the synthesized channel.

    seed: int32 scalar (traced OK) — deterministic per seed.  Returns the
    module's output dict (``cfo`` omitted) plus ``h_true`` (53, B).

    ``stream_sums=True`` is the streaming configuration: ``sums``
    (8, SUM_LANES) holds per-lane Σ|ĥ−h|² of every estimator and Σ|h|²,
    summed over lane groups of SUM_LANES frames, and every other output
    except ``checksum`` keeps only the last SUM_LANES frames (the
    persisted sample).  batch must then be a multiple of SUM_LANES."""
    from tpu80211.datasets import synthetic_sc

    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(seed, jnp.int32))
    k_h, k_n = jax.random.split(key)
    h = synthetic_sc.channel_cfr(k_h, batch, channel_model)  # (53, B)

    sigma_t2 = (10.0 ** (-snr_db / 10.0)) / C.N_FFT
    nsc = np.float32(np.sqrt(C.N_FFT * sigma_t2 / 2.0))
    nois = jax.random.normal(
        k_n, (2, 2 + C.N_BLOCKS, batch, C.N_SC), jnp.float32) * nsc

    hb = _bm(h)                                            # (B, 53)
    tx_pre = Cplx(jnp.broadcast_to(tpre.re[:, 0], (batch, C.N_SC)),
                  jnp.broadcast_to(tpre.im[:, 0], (batch, C.N_SC)))
    n1 = Cplx(nois[0, 0], nois[1, 0])
    n2 = Cplx(nois[0, 1], nois[1, 1])
    rx_pre = tx_pre * hb + (n1 + n2) * 0.5
    d = n2 - n1
    ow2 = jnp.sum(d.abs2(), axis=-1) / (2.0 * C.N_FFT * C.N_SC)

    shape = (batch, C.N_BLOCKS, C.N_SC)
    tx_blocks = Cplx(
        jnp.broadcast_to(txs.re[:, :C.N_BLOCKS].T[None], shape),
        jnp.broadcast_to(txs.im[:, :C.N_BLOCKS].T[None], shape))
    nb = Cplx(jnp.transpose(nois[0, 2:], (1, 0, 2)),
              jnp.transpose(nois[1, 2:], (1, 0, 2)))
    rx_blocks = tx_blocks * Cplx(hb.re[:, None, :], hb.im[:, None, :]) + nb

    out = sc.rx_chain_freq(tx_pre, rx_pre, tx_blocks, rx_blocks, ow2,
                           wiener_model=channel_model, wiener_snr_db=snr_db)
    res = _pack(out, eq_dtype, None)
    del res["cfo"]
    res["h_true"] = h
    if stream_sums:
        assert batch % SUM_LANES == 0, (batch, SUM_LANES)

        def lane_sums(vals):  # (B,) → (SUM_LANES,) summed over lane groups
            return vals.reshape(-1, SUM_LANES).sum(axis=0)

        rows = [lane_sums(jnp.sum((res[n] - h).abs2(), axis=0))
                for n in OUT_NAMES] + [lane_sums(jnp.sum(h.abs2(), axis=0))]
        res["sums"] = jnp.stack(rows)
        for n in OUT_NAMES + ("h_true",):
            res[n] = res[n][:, -SUM_LANES:]
        res["eq"] = res["eq"][:, :, -SUM_LANES:]
        res["ow2"] = res["ow2"][-SUM_LANES:]
    return res
