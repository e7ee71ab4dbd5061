#!/usr/bin/env python
"""On-card smoke test: every production path of the receiver, at the
benchmark's sizes, on one GPU, each compared with a plain reference.

Usage:
    python chip_smoke.py               # six phases on one card
    python chip_smoke.py --four-cards  # the multi-device paths, 4 cards

Phases (one process, one card):
  1. per-frame chain, f32, B=32768 — sc.rx_chain and the lane-major entry
     vs the complex64 reference chain (pipeline/rx.py) on the CPU device
     of this process, 512 frames, at the f32 parity tolerances of
     tests/test_chain_parity.py;
  2. tx-constant, serving and int8 serving chains, B=65536, bf16/int8
     storage, 20 dB SNR — per-estimator NMSE against the true channel
     within 0.1 dB of the f32 chain fed the same stored words, and within
     0.1 dB (bf16) / 8 dB (int8, one batch-wide LSB) of the f32 chain on
     the unrounded frames; served planes equal the non-serving run's (to
     1e-6, one bf16 ulp for eq);
  3. raw receiver, B=32768, ns=2048, stride 16 and 32 — every stream
     detected, timing error in [-4, -2], EVM < 0.1, checksum finite;
  4. generative raw system, B=32768 — detect rate 1.0, timing in band
     ≥ 0.85, mean detected-stream EVM < 0.1, RMS EVM < 0.1 over the
     streams without a deep fade (pipeline/raw.evm_stats), checksum
     finite;
  5. device-resident stream (run_stream_device), gen "kernel" and "raw",
     4 batches at B=32768 — summaries finite, raw detect rate 1.0;
  6. dense MMSE solve, B=8192 — spot systems vs numpy.linalg.solve,
     rel < 5e-5.

Each phase prints its compile seconds, steady step time,
``compiled.memory_analysis()`` and the device's peak bytes in use, and
each comparison with its tolerance and matmul precision.  The last line
is one JSON object naming the device.  Any failed phase raises: the exit
code is then non-zero and that line is not printed.  Without a GPU the
script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# the reference chain of phase 1 runs on this process's CPU device, so
# keep the CPU backend available beside the accelerator
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpu80211 import constants as C  # noqa: E402
from tpu80211.cplx import Cplx  # noqa: E402

PRECISION = "f32 matmuls at HIGHEST; bf16 storage as bf16xbf16->f32"
# tests/test_chain_parity.py::test_sc_chain_vs_native_math
F32_TOLS = {"h_lt": 1e-5, "h_linear": 1e-5, "h_cubic": 1e-5,
            "h_sinc": 1e-5, "h_spline": 1e-5, "h_mmse": 5e-3, "eq": 1e-4}
EST = ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline", "h_wiener",
       "h_mmse")
# phase 2's NMSE gates, dB (see phase_txconst)
SAME_WORDS_TOL_DB = 0.1
FORMAT_TOL_DB = {"bf16": 0.1, "i8": 8.0}


def _emit(kind: str, **fields) -> None:
    print(f"{kind} " + json.dumps(fields), flush=True)


def _check(name: str, value: float, tol: float, ok: bool | None = None,
           precision: str = PRECISION) -> None:
    """Print one comparison, then fail the phase if it does not hold."""
    ok = value <= tol if ok is None else ok
    _emit("CHECK", name=name, value=value, tol=tol, ok=bool(ok),
          precision=precision)
    assert ok, (name, value, tol)


def _measure(name: str, fn, *args, iters: int = 3):
    """Compile ``fn`` for ``args``, run it, time ``iters`` steady calls;
    print compile s, step s, memory analysis and peak device bytes."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    step = (time.perf_counter() - t0) / iters
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k + "_in_bytes", None) for k in
           ("argument_size", "output_size", "temp_size",
            "generated_code_size")} if ma is not None else None
    stats = jax.devices()[0].memory_stats() or {}
    _emit("PHASE", name=name, compile_s=t_compile, step_s=step,
          memory_analysis=mem, peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    return out


def _rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _lane(x: Cplx) -> Cplx:
    return Cplx(x.re.T, x.im.T)


def _capture_consts():
    from tpu80211.datasets.loader import load_capture
    from tpu80211.ops.detect import lts_time_symbol
    from tpu80211.pipeline.lane import tx_spectra

    cap = load_capture()
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    lts = lts_time_symbol(Cplx.from_complex(cap.tx_lptot))
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    evm_den = float(np.sum(np.asarray(txs.re) ** 2 + np.asarray(txs.im) ** 2))
    return cap, txs, tpre, lts, evm_den


# -- phase 1 -------------------------------------------------------------------


def _time_frames(n: int, seed: int = 0):
    """n synthetic time-domain frames (complex128 numpy): packets and
    long preambles, rx through a random channel at 30 dB."""
    from tpu80211.datasets import synthetic

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fb = synthetic.generate(jax.random.PRNGKey(seed), n, snr_db=30.0,
                                dtype=jnp.complex64)
        tx_pkt = np.asarray(synthetic.synthesize_time(fb.tx_symb))
        rx_pkt = np.asarray(synthetic.synthesize_time(fb.rx_symb))
        tx_lp = np.asarray(synthetic.synthesize_preamble_time(
            fb.tx_preamble_fft))
        rx_lp = np.asarray(synthetic.synthesize_preamble_time(
            fb.rx_preamble_fft))
    rng = np.random.default_rng(seed)
    rx_lp = rx_lp + 1e-3 * (rng.standard_normal(rx_lp.shape)
                            + 1j * rng.standard_normal(rx_lp.shape))
    return tx_pkt, rx_pkt, tx_lp, rx_lp


def phase_chain_f32(batch: int = 32768, n_ref: int = 512) -> None:
    """Per-frame f32 chain (batch-major and lane-major) vs the complex64
    reference chain on the CPU device."""
    from tpu80211.pipeline import rx as rx_cpx
    from tpu80211.pipeline import sc
    from tpu80211.pipeline.lane import rx_chain_lane_major

    frames = _time_frames(n_ref)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = jax.jit(rx_cpx.rx_chain)(
            *(jnp.asarray(f, jnp.complex64) for f in frames))
        ref = jax.tree.map(np.asarray, ref)

    reps = -(-batch // n_ref)
    dev = jax.devices()[0]
    args = tuple(
        jax.device_put(Cplx.from_complex(np.tile(f, (reps, 1))[:batch],
                                         jnp.float32), dev)
        for f in frames)
    out = _measure(f"chain_f32_batch_major_B{batch}", sc.rx_chain, *args)
    lane_args = tuple(_lane(a) for a in args)
    lout = _measure(f"chain_f32_lane_major_B{batch}", rx_chain_lane_major,
                    *lane_args)
    for name, tol in F32_TOLS.items():
        want = getattr(ref, name)
        got = getattr(out, name).to_complex()[:n_ref]
        _check(f"chain_f32.{name}_vs_complex64_ref", _rel(got, want), tol)
        lv = lout[name]
        lv = (np.transpose(lv.to_complex(), (2, 0, 1)) if name == "eq"
              else lv.to_complex().T)
        _check(f"chain_f32_lane.{name}_vs_complex64_ref",
               _rel(lv[:n_ref], want), tol)


# -- phase 2 -------------------------------------------------------------------


def _nmse_db(out: dict, h: Cplx) -> dict:
    """Per-estimator CFR NMSE (dB) over the 52 used bins — DC carries no
    energy, and LT-LS forces it to 0, so it would set a floor."""
    used = np.arange(C.N_SC) != C.DC_IDX
    hp = float(jnp.sum(h.abs2()[used]))
    return {n: 10.0 * np.log10(float(jnp.sum((out[n] - h).abs2()[used])) / hp)
            for n in EST if out.get(n) is not None}


def phase_txconst(batch: int = 65536, snr_db: float = 20.0) -> None:
    """tx-constant (bf16), serving (bf16) and int8 serving chains at the
    benchmark's SNR, each estimator's NMSE against the true channel held
    to two gates:

    * same words: within ``SAME_WORDS_TOL_DB`` of the f32 chain fed the
      very values the format stores (bf16 upcast, int8 words times the
      LSB) — what the storage path's own arithmetic costs;
    * format: within ``FORMAT_TOL_DB`` of the f32 chain on the unrounded
      frames — what storing the samples costs as well.  bf16 rounding
      sits about 13 dB below LT-LS's error at 20 dB (+0.08 dB); int8
      with one batch-wide LSB (maxabs/127) adds quantization noise above
      the channel noise (+7.4 dB on LT-LS/MMSE at B=65536), so its limit
      stands between that and a 7-bit scaling (+6 dB more).

    Served planes equal the non-serving run's (to 1e-6; one bf16 ulp
    for eq)."""
    from tpu80211.datasets import synthetic_sc
    from tpu80211.pipeline.lane import quantize_i8, rx_chain_txconst

    _, txs, tpre, _, _ = _capture_consts()
    pkt, lp, h = jax.jit(
        lambda k: synthetic_sc.generate_rx_lane_major(
            k, batch, txs, tpre, snr_db=snr_db, dtype=jnp.float32)
    )(jax.random.PRNGKey(4))

    def run(name, p, l, **kw):
        # constants go in as arguments: captured, XLA would fold their
        # batch-wide broadcasts into the program
        return _measure(name, lambda t, u, a, b: rx_chain_txconst(
            t, u, a, b, **kw), txs, tpre, p, l)

    f32 = jnp.float32
    ref = _nmse_db(run(f"txconst_f32_B{batch}", pkt, lp), h)
    b16 = (pkt.astype(jnp.bfloat16), lp.astype(jnp.bfloat16))
    full16 = run(f"txconst_bf16_B{batch}", *b16)
    serve16 = run(f"txconst_bf16_serve_B{batch}", *b16, serve=True)
    qp, lsb = quantize_i8(pkt)
    ql, _ = quantize_i8(lp, lsb)
    full8 = run(f"txconst_i8_B{batch}", qp, ql, lsb=lsb)
    serve8 = run(f"txconst_i8_serve_B{batch}", qp, ql, lsb=lsb, serve=True)
    words = {
        "bf16": _nmse_db(rx_chain_txconst(
            txs, tpre, *(a.astype(f32) for a in b16)), h),
        "i8": _nmse_db(rx_chain_txconst(
            txs, tpre, qp.astype(f32), ql.astype(f32), lsb=lsb), h)}
    for tag, out in (("bf16", full16), ("bf16_serve", serve16),
                     ("i8", full8), ("i8_serve", serve8)):
        fmt = tag.split("_")[0]
        for n, db in _nmse_db(out, h).items():
            _check(f"txconst_{tag}.{n}_nmse_db_minus_f32_same_words",
                   abs(db - words[fmt][n]), SAME_WORDS_TOL_DB)
            _check(f"txconst_{tag}.{n}_nmse_db_minus_f32",
                   abs(db - ref[n]), FORMAT_TOL_DB[fmt])
    for tag, full, served in (("bf16", full16, serve16),
                              ("i8", full8, serve8)):
        # the served planes are the same values; the two programs differ
        # in their dead outputs, so XLA may fuse (and contract FMAs)
        # differently — hold f32 planes to 1e-6 and the bf16 eq plane to
        # one bf16 ulp, and print whether they came out bitwise equal
        for k in ("h_wiener", "h_mmse", "eq", "ow2", "cfo"):
            pairs = list(zip(jax.tree.leaves(full[k]),
                             jax.tree.leaves(served[k])))
            same = all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in pairs)
            diff = max(_rel(np.asarray(b, np.float32),
                            np.asarray(a, np.float32)) for a, b in pairs)
            _emit("INFO", name=f"serve_{tag}.{k}_bitwise_equal_full",
                  value=bool(same))
            _check(f"serve_{tag}.{k}_vs_full", diff,
                   2.0 ** -7 if k == "eq" else 1e-6,
                   precision="same values; program-level rounding")
        # the checksum is one reduction over every output; with the five
        # diagnostic planes dead XLA fuses it differently, so its sum
        # order — not its terms — differs between the two programs
        _check(f"serve_{tag}.checksum_vs_full",
               _rel(full["checksum"], served["checksum"]), 1e-5,
               precision="f32 sum, reduction order differs")
        assert all(served[k] is None for k in
                   ("h_lt", "h_linear", "h_cubic", "h_sinc", "h_spline"))


# -- phase 3 -------------------------------------------------------------------


def raw_workload(batch: int, ns: int = 2048, dtype=jnp.bfloat16, seed=0):
    """B raw ns-sample streams, each carrying the shipped capture's frame
    at a random offset over 40 dB-down AWGN, lane-major (ns, B)."""
    cap, txs, tpre, lts, evm_den = _capture_consts()
    rng = np.random.default_rng(seed)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((batch, ns), np.float32)
         + 1j * rng.standard_normal((batch, ns), np.float32)) * 1e-4
    offs = rng.integers(40, ns - 1400, batch)
    for i, o in enumerate(offs):
        x[i, o:o + frame.size] += frame
    xt = np.ascontiguousarray(x.T)
    xc = Cplx(jnp.asarray(xt.real, dtype), jnp.asarray(xt.imag, dtype))
    return xc, offs, lts, txs, tpre, evm_den


def phase_raw(batch: int = 32768, ns: int = 2048,
              strides: tuple = (16, 32)) -> None:
    """Raw receiver (detect → align → chain) at each coarse stride."""
    from tpu80211.pipeline.raw import raw_rx_txconst

    x, offs, lts, txs, tpre, evm_den = raw_workload(batch, ns)
    for stride in strides:
        out = _measure(
            f"raw_stride{stride}_B{batch}",
            lambda xr, xi, lt, t, u: raw_rx_txconst(
                Cplx(xr, xi), lt, t, u, stream_sums=True,
                equalize_with="h_mmse", stride=stride),
            x.re, x.im, lts, txs, tpre)
        det = np.asarray(out["detected"])
        err = np.asarray(out["start"]) - offs
        _check(f"raw_s{stride}.missed_streams", float((~det).sum()), 0.0)
        _check(f"raw_s{stride}.timing_err_in_[-4,-2]",
               float(((err < -4) | (err > -2)).sum()), 0.0,
               precision="integer")
        evm = float(np.sqrt(np.asarray(out["evm_sums"]).sum()
                            / (batch * evm_den)))
        _check(f"raw_s{stride}.evm_rms", evm, 0.1)
        _check(f"raw_s{stride}.checksum_finite", 0.0, 0.0,
               ok=bool(np.isfinite(np.asarray(out["checksum"])).all()))


# -- phase 4 -------------------------------------------------------------------


def phase_gen_raw(batch: int = 32768) -> None:
    """Generative raw system: synthesis → detection → chain."""
    from tpu80211.pipeline.raw import evm_stats, gen_raw_system

    _, txs, tpre, lts, _ = _capture_consts()
    out = _measure(f"gen_raw_B{batch}",
                   lambda s, t, u, lt: gen_raw_system(
                       s, batch, t, u, lt, equalize_with="h_mmse"),
                   jnp.int32(7), txs, tpre, lts)
    det = np.asarray(out["detected"])
    err = np.asarray(out["start"]) - np.asarray(out["offsets"])
    in_band = float(((err >= -4) & (err <= -2)).mean())
    _check("gen_raw.detect_rate", float(det.mean()), 1.0,
           ok=bool(det.all()))
    _check("gen_raw.timing_in_band_rate", in_band, 0.85,
           ok=in_band >= 0.85)
    # per-stream EVM: its mean, and the RMS over streams without a deep
    # fade; the batch RMS is set by the one or two deepest fades of B
    # Rayleigh draws (a null divided out by the equalizer), so it is
    # printed, not gated
    ev = evm_stats(out, txs)
    _emit("INFO", name="gen_raw.evm_detected", **ev)
    _check("gen_raw.evm_mean_detected", ev["mean"], 0.1)
    _check("gen_raw.evm_rms_no_deep_fade", ev["rms_no_deep_fade"], 0.1)
    _check("gen_raw.checksum_finite", 0.0, 0.0,
           ok=bool(np.isfinite(np.asarray(out["checksum"])).all()))


# -- phase 5 -------------------------------------------------------------------


def phase_stream(batch: int = 32768, n_batches: int = 4) -> None:
    """Device-resident stream, gen 'kernel' and 'raw'."""
    from tpu80211.pipeline import stream

    for gen in ("kernel", "raw"):
        step, state0 = stream.make_device_stream_step(batch, gen=gen)
        _measure(f"stream_step_{gen}_B{batch}", step, jnp.int32(0), state0)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            res = stream.run_stream_device(n_batches, batch, out_dir=d,
                                           gen=gen)
            wall = time.perf_counter() - t0
            recs = [dict(np.load(os.path.join(d, f"stream_{i:06d}.npz")))
                    for i in range(n_batches)]
        stats = jax.devices()[0].memory_stats() or {}
        _emit("PHASE", name=f"stream_{gen}_{n_batches}x{batch}",
              wall_s_incl_compile=wall, frames=res["frames"],
              peak_bytes_in_use=stats.get("peak_bytes_in_use"))
        finite = all(np.isfinite(v).all() for r in recs for v in r.values())
        _check(f"stream_{gen}.summaries_finite", 0.0, 0.0, ok=finite)
        if gen == "raw":
            rate = min(float(r["detect_rate"]) for r in recs)
            _check("stream_raw.detect_rate", rate, 1.0,
                   ok=rate == 1.0)


# -- phase 6 -------------------------------------------------------------------


def phase_dense(batch: int = 8192) -> None:
    """Dense regularized 53×53 solve (ops/linalg.rank1_solve)."""
    from tpu80211.ops.linalg import rank1_solve

    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    u = Cplx(jax.random.normal(ks[0], (batch, C.N_SC), jnp.float32),
             jax.random.normal(ks[1], (batch, C.N_SC), jnp.float32))
    rx = Cplx(jax.random.normal(ks[2], (batch, C.N_SC), jnp.float32),
              jax.random.normal(ks[3], (batch, C.N_SC), jnp.float32))
    ow2 = jnp.full((batch,), 0.37, jnp.float32)
    z = _measure(f"dense_solve_B{batch}", rank1_solve, u, rx, ow2)
    got = z.to_complex()
    un, rn = u.to_complex(), rx.to_complex()
    worst = 0.0
    for i in range(0, batch, max(1, batch // 7)):
        a = 0.37 * np.eye(C.N_SC) + np.outer(un[i], np.conj(un[i]))
        want = np.linalg.solve(a, rn[i])
        worst = max(worst, float(np.abs(got[i] - want).max()
                                 / np.abs(want).max()))
    _check("dense_solve.spot_rel_vs_numpy", worst, 5e-5,
           precision="complex64 Cholesky + triangular solves")


# -- four cards ----------------------------------------------------------------


def _rate(name: str, fn, args, frames: int, cards: int, iters: int = 5):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    _emit("RATE", name=name, step_s=dt, cards=cards,
          frames_per_s_per_card=frames / dt / cards)
    return out


def four_cards(batch_per_card: int = 32768, n_dev: int = 4) -> None:
    """Frame-parallel paths over n_dev devices vs the same frames on one:
    rx_chain_dp (dp=n_dev), rx_step_shardmap (dp=n_dev/2, blk=2) and the
    meshed generative stream."""
    from tpu80211.datasets import synthetic
    from tpu80211.parallel import (make_mesh, pad_blocks, rx_chain_dp,
                                   rx_step_shardmap, shard_batch)
    from tpu80211.pipeline import sc, stream
    from tpu80211.pipeline.lane import OUT_NAMES, gen_chain

    devs = jax.devices()
    assert len(devs) >= n_dev, (len(devs), n_dev)
    one = devs[0]
    batch = batch_per_card * n_dev

    # rx_chain_dp: frames over dp, zero collectives
    frames = _time_frames(512, seed=1)
    reps = -(-batch // 512)
    host = tuple(Cplx.from_complex(np.tile(f, (reps, 1))[:batch],
                                   jnp.float32) for f in frames)
    mesh = make_mesh(dp=n_dev, blk=1, devices=devs[:n_dev])
    got = _rate("rx_chain_dp", rx_chain_dp(mesh),
                shard_batch(mesh, host), batch, n_dev)
    want = _rate("rx_chain_one_card", jax.jit(sc.rx_chain),
                 jax.device_put(host, one), batch, 1)
    for name in OUT_NAMES + ("eq",):
        _check(f"dp.{name}_vs_one_card",
               _rel(getattr(got, name).to_complex(),
                    getattr(want, name).to_complex()), 1e-6)

    # rx_step_shardmap on (dp, blk=2): psum over blk for the block average
    mesh2 = make_mesh(dp=n_dev // 2, blk=2, devices=devs[:n_dev])
    step, nb_pad = rx_step_shardmap(mesh2)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fb = synthetic.generate(jax.random.PRNGKey(2), 512, snr_db=30.0,
                                dtype=jnp.complex64)
        fb = jax.tree.map(np.asarray, fb)
    rep = lambda a: np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:batch]  # noqa: E731
    c = lambda a: Cplx.from_complex(a, jnp.float32)  # noqa: E731
    fargs = (c(rep(fb.tx_preamble_fft)), c(rep(fb.rx_preamble_fft)),
             c(rep(pad_blocks(fb.tx_symb, 2)[:, :nb_pad])),
             c(rep(pad_blocks(fb.rx_symb, 2)[:, :nb_pad])),
             jnp.asarray(rep(fb.ow2), jnp.float32))
    out2, _ = _rate("rx_step_shardmap_dp_blk2", step, fargs, batch, n_dev)
    ref_args = (fargs[0], fargs[1], fargs[2][:, :C.N_BLOCKS],
                fargs[3][:, :C.N_BLOCKS], fargs[4])
    want2 = _rate("rx_chain_freq_one_card", jax.jit(sc.rx_chain_freq),
                  jax.device_put(ref_args, one), batch, 1)
    for name in OUT_NAMES:
        _check(f"shardmap.{name}_vs_one_card",
               _rel(getattr(out2, name).to_complex(),
                    getattr(want2, name).to_complex()), 1e-6)
    # eq = rx / H: the blk psum's reordered block average moves H by an
    # ulp, and division by near-null bins amplifies that, so eq is held
    # to the f32 chain-parity tolerance instead
    _check("shardmap.eq_vs_one_card",
           _rel(out2.eq.to_complex()[:, :C.N_BLOCKS],
                want2.eq.to_complex()), F32_TOLS["eq"])

    # meshed generative stream: per-shard seeds, one psum per batch
    smesh = make_mesh(dp=n_dev, blk=1, devices=devs[:n_dev])
    sstep, s0 = stream.make_device_stream_step(batch, mesh=smesh)
    summary, _, _ = _rate("gen_stream_mesh", sstep, (jnp.int32(0), s0),
                          batch, n_dev)
    _, txs, tpre, _, _ = _capture_consts()
    sums = 0.0
    for r in range(n_dev):
        kseed = jnp.int32(0 + r * 97003)
        o = jax.jit(lambda s: gen_chain(s, batch_per_card, txs, tpre,
                                        snr_db=20.0, stream_sums=True))(
            jax.device_put(kseed, one))
        sums = sums + np.asarray(o["sums"], np.float64).sum(axis=-1)
    for k, name in enumerate(OUT_NAMES):
        _check(f"gen_stream_mesh.{name}_nmse_vs_one_card",
               abs(float(summary[name + "_nmse"]) - sums[k] / sums[-1])
               / (sums[k] / sums[-1]), 1e-6)


# -- driver --------------------------------------------------------------------


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    from tpu80211.utils.compile_cache import enable_compile_cache

    _emit("SETUP", compile_cache=enable_compile_cache(),
          jax=jax.__version__, devices=len(devs))
    if args.four_cards:
        four_cards()
        count = 4
    else:
        phase_chain_f32()
        phase_txconst()
        phase_raw()
        phase_gen_raw()
        phase_stream()
        phase_dense()
        count = 1
    print(_card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
