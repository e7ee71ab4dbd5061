"""Streaming driver: chunked processing, persistence, resume."""

import json

import numpy as np
import pytest

from tpu80211 import constants as C
from tpu80211.pipeline import stream


def test_stream_runs_and_persists(tmp_path):
    out_dir = tmp_path / "shards"
    res = stream.run_stream(
        stream.synthetic_batches(3, batch=4), out_dir=str(out_dir)
    )
    assert res["frames"] == 12
    assert res["batches"] == 3
    files = sorted(out_dir.glob("h_est_*.npz"))
    assert len(files) == 3
    d = np.load(files[0])
    assert d["h_mmse"].shape == (4, C.N_SC)
    assert np.isfinite(d["h_mmse"]).all()
    cursor = json.loads((out_dir / "cursor.json").read_text())
    assert cursor["done"] == [0, 1, 2]


def test_stream_resume_skips_done(tmp_path):
    out_dir = tmp_path / "shards"
    stream.run_stream(stream.synthetic_batches(2, batch=4), out_dir=str(out_dir))
    # second run with 4 batches resumes: only 2 new ones processed
    res = stream.run_stream(
        stream.synthetic_batches(4, batch=4), out_dir=str(out_dir), resume=True
    )
    assert res["batches"] == 2
    assert len(list(out_dir.glob("h_est_*.npz"))) == 4


def test_device_stream_runs_persists_resumes(tmp_path):
    """Device-resident stream (on-device generation + chain): summaries
    + sampled estimates persisted, resumable, channel actually recovered."""
    out_dir = tmp_path / "dstream"
    res = stream.run_stream_device(2, 128, out_dir=str(out_dir), sample=8,
                                   snr_db=35.0)
    assert res["frames"] == 256
    files = sorted(out_dir.glob("stream_*.npz"))
    assert len(files) == 2
    d = np.load(files[0])
    assert d["h_mmse_sample"].shape == (8, C.N_SC)
    assert np.isfinite(d["h_mmse_sample"]).all()
    # at SNR 35 the full-preamble estimators track the channel closely;
    # NMSE is a *power ratio* here (not dB) — lt/mmse well under -10 dB
    assert float(d["h_lt_nmse"]) < 0.1
    assert float(d["h_mmse_nmse"]) < 0.1
    # pilot interpolators are worse but bounded
    assert float(d["h_wiener_nmse"]) < 0.5
    # resume skips everything already recorded
    res2 = stream.run_stream_device(2, 128, out_dir=str(out_dir), sample=8,
                                    snr_db=35.0)
    assert res2["frames"] == 0


def test_device_stream_resume_is_bit_deterministic(tmp_path):
    """A resumed device stream restores the persisted carried state, so
    batches after the resume boundary are bit-identical to an
    uninterrupted run (ADVICE round-3: `continue` without advancing the
    state made resumed shards diverge)."""
    a_dir = tmp_path / "uninterrupted"
    b_dir = tmp_path / "resumed"
    stream.run_stream_device(4, 128, out_dir=str(a_dir), sample=8,
                             snr_db=35.0)
    stream.run_stream_device(2, 128, out_dir=str(b_dir), sample=8,
                             snr_db=35.0)
    stream.run_stream_device(4, 128, out_dir=str(b_dir), sample=8,
                             snr_db=35.0)
    for i in (2, 3):  # the batches computed after the resume boundary
        a = np.load(a_dir / f"stream_{i:06d}.npz")
        b = np.load(b_dir / f"stream_{i:06d}.npz")
        np.testing.assert_array_equal(a["h_mmse_sample"],
                                      b["h_mmse_sample"], err_msg=str(i))
        np.testing.assert_array_equal(a["h_mmse_nmse"], b["h_mmse_nmse"])
    # states persisted for every batch in both runs
    cur = json.loads((b_dir / "cursor.json").read_text())
    assert set(cur["states"]) == {"0", "1", "2", "3"}


def test_raw_stream_mode(tmp_path):
    """gen='raw': device-synthesized raw sample streams → the raw
    receiver; detection/timing/channel-quality summaries are sane and
    the steps chain deterministically."""
    import jax.numpy as jnp

    step, s0 = stream.make_device_stream_step(128, snr_db=30.0, gen="raw")
    summary, sample_h, s1 = step(0, s0)
    assert float(summary["detect_rate"]) == 1.0
    assert float(summary["timing_in_band_rate"]) > 0.7
    # channel magnitude recovered (ramp-free metric); EVM is blend-limited
    assert float(summary["h_mmse_mag_nmse"]) < 0.1
    assert np.isfinite(float(summary["evm_rms"]))
    assert sample_h.re.shape == (53, 128)
    # deterministic per (i, state); different state → different batch
    s_b, h_b, _ = step(0, s0)
    np.testing.assert_array_equal(np.asarray(sample_h.re),
                                  np.asarray(h_b.re))
    _, h_c, _ = step(0, s1 + 3)
    assert not np.array_equal(np.asarray(sample_h.re), np.asarray(h_c.re))


def test_raw_equalize_with_mmse_quality():
    """equalize_with='h_mmse' on the generative raw system: the
    full-preamble MMSE estimate equalizes the dispersive channel the
    golden PS-Linear blend cannot (EVM 2.7 → ~0.03 at SNR 30)."""
    import jax
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx
    from tpu80211.datasets.loader import load_capture
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.raw import gen_raw_system
    from tpu80211.ops.detect import lts_time_symbol

    cap = load_capture()
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    lts = lts_time_symbol(Cplx.from_complex(cap.tx_lptot))
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    den = float(np.sum(np.asarray(txs.re[:, :15]) ** 2
                       + np.asarray(txs.im[:, :15]) ** 2))

    def evm(eqw):
        out = gen_raw_system(jnp.int32(7), 128, txs, tpre, lts,
                             snr_db=30.0, equalize_with=eqw)
        return float(np.sqrt(np.sum(np.asarray(out["evm_sums"]))
                             / (128 * den)))

    e_lin, e_mmse = evm("h_linear"), evm("h_mmse")
    assert e_mmse < 0.1, e_mmse
    assert e_mmse < e_lin / 10.0, (e_lin, e_mmse)


def test_gen_raw_cfo_impairment_and_recovery():
    """cfo_khz: per-stream carrier offsets up to ±40 kHz are synthesized
    and recovered by the chain's Moose CFO + pilot CPE stages."""
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx
    from tpu80211.datasets.loader import load_capture
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.raw import gen_raw_system
    from tpu80211.ops.detect import lts_time_symbol

    cap = load_capture()
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    lts = lts_time_symbol(Cplx.from_complex(cap.tx_lptot))
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    out = gen_raw_system(jnp.int32(3), 128, txs, tpre, lts, snr_db=30.0,
                         equalize_with="h_mmse", cfo_khz=40.0)
    assert np.asarray(out["detected"]).all()
    # Moose CFO recovery: estimate within 200 Hz of truth (median)
    err_hz = np.abs(np.asarray(out["cfo"])
                    - np.asarray(out["cfo_true"])) * 20e6
    assert np.median(err_hz) < 200.0, np.median(err_hz)
    # equalized symbols survive the impairment
    den = float(np.sum(np.asarray(txs.re[:, :15]) ** 2
                       + np.asarray(txs.im[:, :15]) ** 2))
    evm = float(np.sqrt(np.sum(np.asarray(out["evm_sums"]))
                        / (128 * den)))
    assert evm < 0.15, evm


def test_kernel_raw_stream_mode():
    """gen='raw' with f32 sample storage: the generative raw system
    (raw-stream generator + receiver, pipeline/raw.gen_raw_system)
    behind the stream step — summaries sane, steps deterministic."""
    import jax.numpy as jnp

    step, s0 = stream.make_device_stream_step(128, snr_db=30.0, gen="raw",
                                              dtype=jnp.float32)
    summary, sample_h, s1 = step(0, s0)
    assert float(summary["detect_rate"]) == 1.0
    assert float(summary["h_mmse_mag_nmse"]) < 0.1
    assert np.isfinite(float(summary["evm_rms"]))
    assert sample_h.re.shape == (53, 128)
    s_b, h_b, _ = step(0, s0)
    np.testing.assert_array_equal(np.asarray(sample_h.re),
                                  np.asarray(h_b.re))


def test_kernel_raw_stream_mesh_mode():
    """gen='raw' with a dp mesh: per-shard generative raw system,
    summaries combined by one psum — runs on the virtual CPU mesh."""
    import jax
    import jax.numpy as jnp

    from tpu80211.parallel import make_mesh

    mesh = make_mesh(dp=2, blk=1, devices=jax.devices()[:2])
    step, s0 = stream.make_device_stream_step(256, snr_db=30.0,
                                              gen="raw", mesh=mesh)
    summary, sample_h, s1 = step(jnp.int32(0), s0)
    assert float(summary["detect_rate"]) == 1.0
    assert np.isfinite(float(summary["evm_rms"]))
    assert float(summary["h_mmse_mag_nmse"]) < 0.1
    assert sample_h.re.shape == (53, 256)


def test_device_stream_steps_are_chained():
    """The carried state makes each batch's generator key depend on the
    previous batch's outputs — the device-side serialization the
    throughput methodology relies on."""
    import jax.numpy as jnp

    step, state0 = stream.make_device_stream_step(128, snr_db=35.0)
    s1, h1, st1 = step(0, state0)
    s2, h2, st2 = step(1, st1)
    # same index, different carried state ⇒ different batch
    s2b, h2b, _ = step(1, state0 + 7)
    assert not np.allclose(np.asarray(h2.re), np.asarray(h2b.re))
    # deterministic: same (i, state) ⇒ same batch
    s2c, h2c, _ = step(1, st1)
    np.testing.assert_array_equal(np.asarray(h2.re), np.asarray(h2c.re))


def test_gen_chain_contract(capture):
    """gen_chain: output contract, estimator statistics at SNR 35, σ̂²
    unbiasedness, determinism, seed sensitivity."""
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.lane import gen_chain

    txs, tpre = tx_spectra(
        Cplx.from_complex(capture.tx_packet),
        Cplx.from_complex(capture.tx_lptot),
    )
    out = gen_chain(jnp.int32(7), 256, txs, tpre, snr_db=35.0)
    h = out["h_true"].to_complex()
    assert out["eq"].shape == (C.N_BLOCKS, C.N_SC, 256)
    for name, bound_db in (("h_lt", -12.0), ("h_mmse", -12.0),
                           ("h_wiener", -5.0)):
        e = out[name].to_complex()
        nmse = 10 * np.log10(np.sum(np.abs(e - h) ** 2)
                             / np.sum(np.abs(h) ** 2))
        assert nmse < bound_db, (name, nmse)
    ow2 = float(np.mean(np.asarray(out["ow2"])))
    target = 10 ** (-3.5) / 64
    assert abs(ow2 - target) / target < 0.2
    out2 = gen_chain(jnp.int32(7), 256, txs, tpre, snr_db=35.0)
    np.testing.assert_array_equal(np.asarray(out["h_mmse"].re),
                                  np.asarray(out2["h_mmse"].re))
    out3 = gen_chain(jnp.int32(8), 256, txs, tpre, snr_db=35.0)
    assert not np.array_equal(np.asarray(out["h_mmse"].re),
                              np.asarray(out3["h_mmse"].re))


def test_gen_chain_stream_sums_match_full(capture):
    """stream_sums=True: the per-lane summary sums equal the sums
    computed from the full-output run at the same seed."""
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.lane import OUT_NAMES as _OUT_NAMES, gen_chain

    txs, tpre = tx_spectra(
        Cplx.from_complex(capture.tx_packet),
        Cplx.from_complex(capture.tx_lptot),
    )
    full = gen_chain(jnp.int32(5), 256, txs, tpre, snr_db=30.0)
    st = gen_chain(jnp.int32(5), 256, txs, tpre, snr_db=30.0,
                         stream_sums=True)
    assert st["sums"].shape == (8, 128)
    got = np.asarray(st["sums"]).sum(axis=-1)
    h = full["h_true"]
    want = np.asarray(
        [float(np.sum((full[n] - h).abs2())) for n in _OUT_NAMES]
        + [float(np.sum(h.abs2()))]
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # sample tiles are slices of the full outputs (the LAST 128 lanes)
    np.testing.assert_array_equal(
        np.asarray(st["h_mmse"].re), np.asarray(full["h_mmse"].re[:, -128:])
    )
    # checksum (the stream's state carrier) stays batch-wide and equal
    np.testing.assert_array_equal(
        np.asarray(st["checksum"]), np.asarray(full["checksum"])
    )


def test_plots(tmp_path, capture):
    from tpu80211.utils.plots import plot_cfr
    import jax.numpy as jnp
    from tpu80211.models import lt_ls

    h = np.asarray(
        lt_ls(jnp.asarray(capture.tx_preamble_fft), jnp.asarray(capture.rx_preamble_fft))
    )
    paths = plot_cfr({"LT-LS": h}, str(tmp_path / "cfr"), title="test")
    for p in paths:
        assert (tmp_path / p.split("/")[-1]).exists()


def test_timing_report():
    from tpu80211.utils.timing import Report, roofline, rx_chain_cost

    kind = "NVIDIA H100 80GB HBM3"
    r = Report(meta={"device_kind": kind})
    cost = rx_chain_cost(1024)
    r.add("rx_chain", **roofline(cost["flops"], cost["bytes"], kind))
    obj = json.loads(r.json())
    assert obj["rx_chain"]["bound"] in ("compute", "memory")
    assert obj["rx_chain"]["t_light_s"] > 0


def test_peak_table_lookup():
    """The peak table is keyed by device_kind; the H100 row carries the
    data-sheet figures, and an unknown device raises instead of falling
    back to a default."""
    from tpu80211.utils.timing import device_peaks, roofline

    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["tflops"]["bf16"] == 989.0 and p["hbm_gb_s"] == 3350.0
    r = roofline(0.0, 3350e9, "NVIDIA H100 80GB HBM3")
    assert r["bound"] == "memory" and abs(r["t_light_s"] - 1.0) < 1e-12
    for kind in ("cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            device_peaks(kind)


def test_checks_assert_finite():
    from tpu80211.utils.checks import assert_finite
    from tpu80211.cplx import Cplx
    import jax.numpy as jnp
    import pytest as _pt

    ok = Cplx(jnp.ones((3,)), jnp.zeros((3,)))
    assert_finite({"a": ok, "b": jnp.ones(2)})
    bad = Cplx(jnp.asarray([1.0, np.nan]), jnp.zeros((2,)))
    with _pt.raises(FloatingPointError):
        assert_finite(bad, name="bad")


def test_checked_wrapper_raises_on_nan():
    from tpu80211.utils.checks import checked
    import jax.numpy as jnp
    import pytest as _pt

    def div(x, y):
        return x / y

    f = checked(div)
    assert float(f(jnp.float32(1.0), jnp.float32(2.0))) == 0.5
    with _pt.raises(Exception):
        f(jnp.float32(0.0), jnp.float32(0.0))


def test_multihost_mesh_single_process():
    from tpu80211.parallel import multihost
    import jax

    mesh = multihost.hierarchical_mesh(blk=2)
    assert mesh.shape["host"] == 1
    assert mesh.shape["dp"] * mesh.shape["blk"] == len(jax.devices())
    s = multihost.frame_sharding_mh(mesh)
    assert s is not None


def test_main_module_entrypoint():
    """python -m tpu80211 works (tpu80211/__main__.py)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "tpu80211", "devices"],
        capture_output=True, text=True, timeout=240,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr
    out = r.stdout.lower()
    assert "device" in out or "cpu" in out, r.stdout


def test_cli_raw_subcommand():
    """python -m tpu80211 raw: the raw-receiver demo detects every
    embedded frame."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "tpu80211", "raw", "--batch", "128"],
        capture_output=True, text=True, timeout=480,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-1500:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["detected"] == rec["streams"] == 128
    assert -4 <= rec["timing_err_min"] <= rec["timing_err_max"] <= -2


def test_init_distributed_single_process_noop():
    """init_distributed after backend init: warns or no-ops, never raises
    for the implicit single-process case."""
    import warnings

    from tpu80211.parallel import multihost

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        multihost.init_distributed()  # backend already up from conftest


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_compile_cache_path_rule(env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as-is and nothing is
    set in code; otherwise the cache sits at a fixed path in the
    checkout."""
    import pathlib

    from tpu80211.utils import compile_cache

    environ = {} if env_dir is None else {compile_cache.ENV: env_dir}
    path, set_in_code = compile_cache.cache_dir(environ)
    if env_dir is None:
        root = pathlib.Path(__file__).resolve().parents[1]
        assert path == str(root / ".jax_cache") and set_in_code
    else:
        assert path == env_dir and not set_in_code
