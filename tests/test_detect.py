"""Packet detection + timing sync (ops/detect.py) — the stage the
reference's ``threshold`` parameter promises (WiFi_RX.m:7) but never
implements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu80211.cplx import Cplx
from tpu80211.datasets import synthetic
from tpu80211.ops import detect

B, N = 16, 2048


def _noise(rng, shape, amp):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * amp


def _embed(rng, lp, pkt, amp=0.01):
    stream = _noise(rng, (B, N), amp)
    offs = rng.integers(50, N - 1400, B)
    for i, o in enumerate(offs):
        stream[i, o:o + 160] += lp if lp.ndim == 1 else lp[i]
        stream[i, o + 160:o + 1360] += pkt[i]
    return Cplx.from_complex(stream, jnp.float64), offs


def _clean_preamble():
    lts = synthetic._lts_spectrum().astype(np.complex128)
    return np.asarray(synthetic.synthesize_preamble_time(jnp.asarray(lts)))


def test_detect_exact_on_clean_channel():
    rng = np.random.default_rng(0)
    lp1 = _clean_preamble()
    fb = synthetic.generate(jax.random.PRNGKey(1), B, snr_db=30.0)
    pkt = np.asarray(synthetic.synthesize_time(jnp.asarray(np.asarray(fb.tx_symb))))
    x, offs = _embed(rng, lp1, pkt)
    ref = detect.lts_time_symbol(lp1)
    res = jax.jit(lambda x: detect.detect_packet(x, ref))(x)
    assert np.asarray(res["detected"]).all()
    # default timing advance of 4: start = true offset - 4 exactly
    np.testing.assert_array_equal(np.asarray(res["start"]), offs - 4)


def test_detect_through_channel_within_cp():
    """Through a random per-frame channel the start lands within a few
    samples (the channel's bulk delay) — inside the cyclic prefix, so the
    chain equalizes the residual as a phase ramp."""
    rng = np.random.default_rng(0)
    fb = synthetic.generate(jax.random.PRNGKey(1), B, snr_db=30.0)
    lp = np.asarray(synthetic.synthesize_preamble_time(
        jnp.asarray(fb.tx_preamble_fft) * jnp.asarray(fb.h_true)))
    pkt = np.asarray(synthetic.synthesize_time(jnp.asarray(np.asarray(fb.rx_symb))))
    x, offs = _embed(rng, lp, pkt)
    ref = detect.lts_time_symbol(_clean_preamble())
    res = jax.jit(lambda x: detect.detect_packet(x, ref))(x)
    assert np.asarray(res["detected"]).all()
    err = np.asarray(res["start"]) - offs
    # within [-advance, +CP/2): early is safe (cyclic), late is bounded
    assert (err >= -4).all() and (err < 8).all(), err


def test_detect_capture_frame(capture):
    """The shipped capture (real channel 'A' + 20 kHz CFO) embedded in
    noise: detected with ≤2-sample timing spread."""
    rng = np.random.default_rng(0)
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (B, N), 0.002)
    offs = rng.integers(50, N - 1400, B)
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    x = Cplx.from_complex(stream, jnp.float64)
    ref = detect.lts_time_symbol(capture.tx_lptot)
    res = jax.jit(lambda x: detect.detect_packet(x, ref))(x)
    assert np.asarray(res["detected"]).all()
    err = np.asarray(res["start"]) - offs
    assert (err >= -4).all() and (err <= 0).all(), err


def test_no_false_alarm_on_noise(capture):
    rng = np.random.default_rng(3)
    x = Cplx.from_complex(_noise(rng, (8, N), 0.002), jnp.float64)
    res = detect.detect_packet(x, detect.lts_time_symbol(capture.tx_lptot))
    assert not np.asarray(res["detected"]).any()
    # undetected rows return sentinel indices, never plausible garbage
    # (ADVICE round-3): -1 everywhere when the metric never crossed
    assert (np.asarray(res["coarse"]) == -1).all()
    assert (np.asarray(res["start"]) == -1).all()


def test_extract_and_run_chain(capture):
    """End-to-end: raw stream → detect → extract → full RX chain equals
    the chain run on the pre-aligned frame (the detected offset is exact
    at this SNR for the capture)."""
    from tpu80211.config import EstimatorMode
    from tpu80211.pipeline import rx as rx_cpx

    rng = np.random.default_rng(7)
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (4, N), 1e-5)  # near-noiseless: bit-level check
    offs = rng.integers(50, N - 1400, 4)
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    x = Cplx.from_complex(stream, jnp.float64)
    ref = detect.lts_time_symbol(capture.tx_lptot)
    res = detect.detect_packet(x, ref)
    err = np.asarray(res["start"]) - offs
    # the capture's channel has ~1 sample of bulk delay; with the
    # default 4-sample timing advance the start lands a few samples
    # EARLY — inside the cyclic prefix, a pure per-bin phase ramp
    assert (err >= -4).all() and (err <= -2).all(), err
    lp, pkt = detect.extract_packet(x, res["start"])
    # extraction plumbing: the slices equal the stream at the detected
    # offsets exactly
    for i in range(4):
        s = int(np.asarray(res["start"])[i])
        np.testing.assert_array_equal(
            np.asarray(lp.re)[i], np.asarray(x.re)[i, s:s + 160])
        np.testing.assert_array_equal(
            np.asarray(pkt.re)[i], np.asarray(x.re)[i, s + 160:s + 1360])
    out = rx_cpx.rx_chain(
        jnp.broadcast_to(jnp.asarray(capture.tx_packet), (4, 1200)),
        jnp.asarray(pkt.re + 1j * pkt.im),
        jnp.broadcast_to(jnp.asarray(capture.tx_lptot), (4, 160)),
        jnp.asarray(lp.re + 1j * lp.im),
        mode=EstimatorMode.MATLAB,
    )
    want = rx_cpx.rx_chain(
        jnp.asarray(capture.tx_packet), jnp.asarray(capture.rx_packet),
        jnp.asarray(capture.tx_lptot), jnp.asarray(capture.rx_lptot),
        mode=EstimatorMode.MATLAB,
    )
    # a residual sample of timing offset multiplies the CFR by a known
    # per-bin phase ramp (identical on preamble and data) — the channel
    # MAGNITUDE estimate must be preserved; phase-ramp sensitivity of the
    # 4-pilot interpolators under residual timing is an estimator
    # property, not detection's (LT-LS is per-bin and ramp-proof)
    got_mag = np.abs(np.asarray(out.h_lt))
    want_mag = np.abs(np.asarray(want.h_lt))
    # early (cyclic) extraction preserves magnitudes up to two physical
    # residuals of this real capture: the channel transient occupying the
    # first CP samples (non-cyclic energy from whatever preceded the
    # recorded preamble) and the 20 kHz CFO's ICI pattern re-sampled at
    # the shifted window (measured: 2.6%)
    rel = np.abs(got_mag - want_mag).max() / want_mag.max()
    assert rel < 4e-2, rel


def test_raw_rx_pipeline_matches_prealigned(capture):
    """pipeline/raw.py: raw streams → detect_and_align → tx-constant
    chain equals the chain on the pre-aligned frames."""
    from tpu80211.pipeline import raw
    from tpu80211.pipeline.lane import rx_chain_txconst, tx_spectra

    rng = np.random.default_rng(9)
    nb = 4
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (nb, N), 1e-5)
    offs = rng.integers(50, N - 1400, nb)
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    x = Cplx.from_complex(np.ascontiguousarray(stream.T), jnp.float32)
    lts = detect.lts_time_symbol(capture.tx_lptot)
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    txs, tpre = tx_spectra(Cplx.from_complex(capture.tx_packet, jnp.float32),
                           Cplx.from_complex(capture.tx_lptot, jnp.float32))
    out = raw.raw_rx_txconst(x, lts, txs, tpre)
    assert np.asarray(out["detected"]).all()
    starts = np.asarray(out["start"])
    assert ((starts - offs >= -4) & (starts - offs <= -2)).all()

    # reference: chain on the frames sliced at the SAME detected starts
    lp_re = np.stack([stream[i, starts[i]:starts[i] + 160].real
                      for i in range(nb)], axis=1)
    lp_im = np.stack([stream[i, starts[i]:starts[i] + 160].imag
                      for i in range(nb)], axis=1)
    pk_re = np.stack([stream[i, starts[i] + 160:starts[i] + 1360].real
                      for i in range(nb)], axis=1)
    pk_im = np.stack([stream[i, starts[i] + 160:starts[i] + 1360].imag
                      for i in range(nb)], axis=1)
    want = rx_chain_txconst(
        txs, tpre,
        Cplx(jnp.asarray(pk_re, jnp.float32), jnp.asarray(pk_im, jnp.float32)),
        Cplx(jnp.asarray(lp_re, jnp.float32), jnp.asarray(lp_im, jnp.float32)),
    )
    got = np.asarray(out["h_mmse"].re)
    ref_h = np.asarray(want["h_mmse"].re)
    np.testing.assert_allclose(got, ref_h, rtol=1e-4, atol=1e-6)


def test_raw_rx_under_shard_map(capture):
    """The raw receiver composes with a dp-sharded mesh (streams split
    across devices; detection is embarrassingly parallel) — sharded ==
    unsharded on the virtual CPU mesh."""
    import jax
    from jax.sharding import PartitionSpec as P

    from tpu80211.parallel import make_mesh
    from tpu80211.pipeline import raw
    from tpu80211.pipeline.lane import tx_spectra

    rng = np.random.default_rng(11)
    b = 32  # 16 per shard
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (b, N), 1e-4)
    offs = rng.integers(50, N - 1400, b)
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    x = Cplx.from_complex(np.ascontiguousarray(stream.T), jnp.float32)
    lts = detect.lts_time_symbol(capture.tx_lptot)
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    txs, tpre = tx_spectra(Cplx.from_complex(capture.tx_packet, jnp.float32),
                           Cplx.from_complex(capture.tx_lptot, jnp.float32))

    want = raw.raw_rx_txconst(x, lts, txs, tpre)

    mesh = make_mesh(dp=2, blk=1, devices=jax.devices()[:2])
    lane2 = Cplx(P(None, "dp"), P(None, "dp"))
    out_specs = {
        **{k: lane2 for k in ("h_lt", "h_linear", "h_cubic", "h_sinc",
                              "h_spline", "h_wiener", "h_mmse")},
        "eq": Cplx(P(None, None, "dp"), P(None, None, "dp")),
        "ow2": P("dp"), "cfo": P("dp"), "checksum": P("dp"),
        "detected": P("dp"), "start": P("dp"), "metric": P("dp"),
    }
    mapped = jax.shard_map(
        lambda xs: raw.raw_rx_txconst(xs, lts, txs, tpre),
        mesh=mesh, in_specs=(lane2,), out_specs=out_specs,
    )
    got = mapped(x)
    np.testing.assert_array_equal(np.asarray(got["start"]),
                                  np.asarray(want["start"]))
    np.testing.assert_allclose(np.asarray(got["h_mmse"].re),
                               np.asarray(want["h_mmse"].re),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["checksum"]),
                               np.asarray(want["checksum"]), rtol=1e-5)


def test_metric_bounded_by_one(capture):
    """Cauchy-Schwarz: the both-window-normalized metric never exceeds 1
    (the single-window form spiked to 1.5 in data regions — fixed)."""
    rng = np.random.default_rng(1)
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (2, N), 0.002)
    stream[:, 100:1460] += frame
    m = detect.autocorr_metric(Cplx.from_complex(stream, jnp.float64))
    assert float(np.max(np.asarray(m))) <= 1.0 + 1e-9


def _capture_streams(capture, b, amp, seed):
    """Lane-major (N, b) streams carrying the capture at random offsets."""
    rng = np.random.default_rng(seed)
    frame = np.concatenate([capture.rx_lptot, capture.rx_packet])
    stream = _noise(rng, (b, N), amp)
    offs = rng.integers(40, N - 1400, b)
    for i, o in enumerate(offs):
        stream[i, o:o + 1360] += frame
    return stream, offs


@pytest.mark.parametrize("stride", [16, 32, 64])
def test_decimated_detection_keeps_fine_timing(capture, stride):
    """The stride-decimated coarse metric is M at every stride-th offset
    exactly, and detection + fine timing equal the full-resolution path;
    only ``coarse`` becomes stride-granular."""
    stream, _ = _capture_streams(capture, 12, 1e-4, 5)
    x = Cplx.from_complex(stream, jnp.float32)
    ref = detect.lts_time_symbol(capture.tx_lptot)
    full = detect.detect_packet(x, ref)
    dec = detect.detect_packet(x, ref, stride=stride)
    np.testing.assert_array_equal(np.asarray(dec["detected"]),
                                  np.asarray(full["detected"]))
    np.testing.assert_array_equal(np.asarray(dec["start"]),
                                  np.asarray(full["start"]))
    assert (np.asarray(dec["coarse"]) % stride == 0).all()
    # metric identity at f64: the cumsum window sums of the f32 path
    # lose relative precision in the noise floor
    x64 = Cplx.from_complex(stream, jnp.float64)
    m_full = np.asarray(detect.autocorr_metric(x64))
    m_dec = np.asarray(detect.autocorr_metric(x64, stride))
    np.testing.assert_allclose(
        m_dec, m_full[:, ::stride][:, :m_dec.shape[-1]], rtol=1e-9,
        atol=1e-12)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_detect_and_align_extracts_exact_slices(capture, dtype):
    """Lane-major detection + gather alignment returns the stream's own
    samples at the detected starts, in the storage dtype."""
    stream, offs = _capture_streams(capture, 8, 1e-4, 7)
    xt = np.ascontiguousarray(stream.T)
    x = Cplx(jnp.asarray(xt.real, dtype), jnp.asarray(xt.imag, dtype))
    lts = detect.lts_time_symbol(capture.tx_lptot)
    det, lp, pkt = detect.detect_and_align(x, lts, stride=16)
    assert np.asarray(det["detected"]).all()
    s = np.asarray(det["start"])
    assert ((s - offs >= -4) & (s - offs <= -2)).all()
    assert lp.re.dtype == dtype and pkt.im.dtype == dtype
    xr = np.asarray(x.re, np.float32)
    xi = np.asarray(x.im, np.float32)
    want_lp = np.stack([xr[s[l]:s[l] + 160, l] for l in range(8)], axis=1)
    want_pk = np.stack([xi[s[l] + 160:s[l] + 1360, l] for l in range(8)],
                       axis=1)
    np.testing.assert_array_equal(np.asarray(lp.re, np.float32), want_lp)
    np.testing.assert_array_equal(np.asarray(pkt.im, np.float32), want_pk)


def test_place_streams_matches_roll():
    """place_streams moves each stream's frame down by its offset
    (circularly) and adds the noise field."""
    rng = np.random.default_rng(3)
    ns, b = 256, 5
    sig = rng.standard_normal((ns, b)) + 1j * rng.standard_normal((ns, b))
    noise = rng.standard_normal((ns, b)) + 1j * rng.standard_normal((ns, b))
    offs = np.array([0, 1, 37, 128, 255])
    got = detect.place_streams(Cplx.from_complex(sig, jnp.float64),
                               Cplx.from_complex(noise, jnp.float64),
                               jnp.asarray(offs)).to_complex()
    want = np.stack([np.roll(sig[:, l], offs[l]) for l in range(b)],
                    axis=1) + noise
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ns", [1360, 1400])
def test_raw_generator_rejects_streams_without_room(capture, ns):
    """The raw-stream generator refuses an ``ns`` that leaves no offset
    range for the frame (ns must exceed 1360 + the 40-sample minimum)."""
    from tpu80211.datasets import synthetic_sc
    from tpu80211.pipeline.lane import tx_spectra

    txs, tpre = tx_spectra(Cplx.from_complex(capture.tx_packet, jnp.float32),
                           Cplx.from_complex(capture.tx_lptot, jnp.float32))
    with pytest.raises(ValueError, match="no room"):
        synthetic_sc.generate_raw_lane_major(jax.random.PRNGKey(0), 4, txs,
                                             tpre, ns=ns)
