#!/usr/bin/env python
"""Benchmark: estimated + equalized frames/s of the full RX chain on one
GPU.

Runs the full split-complex RX chain (time-domain packets → block
extraction → all seven estimators (LT-LS, PS linear/cubic/sinc/spline/
Wiener, PS-MMSE) → blended equalization (PS-Linear blend, the golden
model's choice, WiFi_RX.m:60), pipeline/sc.py and pipeline/lane.py) and
prints ONE JSON line:

    {"metric": "...", "value": N, "unit": "frames/s", "vs_baseline": N, ...}

The default invocation measures every row below, each in a child process
of its own; the parent never imports JAX, so exactly one process holds
the card at a time.  The headline is the tx-constant chain:

  * "txconst" — every frame shares one known transmit packet, passed as
    its precomputed spectra (the reference itself replays a single fixed
    frame, inputs.h), B=65536;
  * "lane" — per-frame tx packets (the general case), B=32768;
  * "txserve" / "txi8" — tx-constant serving outputs, bf16 / int8 words;
  * "raw" / "raw32" — raw sample streams → detection → alignment →
    chain at coarse strides 16 / 32, B=32768, gated before timing;
  * "genraw" — raw streams synthesized on device, then received;
  * "dense" — the dense regularized 53×53 solve, B=8192, gated.

Every row names the platform, device kind, device count and power limit
it ran on.  Without a GPU the run fails; ``--cpu`` makes it an explicit
CPU rehearsal whose rows say so.

Methodology:
  * a base frame batch is synthesized on device once; the timed loop feeds
    each iteration a scalar perturbation DERIVED FROM THE PREVIOUS
    ITERATION'S OUTPUT, so every step is data-dependent on the last —
    no caching, no deduplication, no reordering is possible;
  * each step returns its outputs beside that scalar, so their writes
    stay in the timed program (a step returning the scalar alone would
    let XLA drop every write the scalar does not need);
  * the fence is a device→host readback of the final scalar;
  * two loop lengths (iters and 2·iters) are timed and the MARGINAL cost
    (dt2 − dt1)/iters cancels fixed dispatch overheads;
  * a SECOND independent fence — the marginal over BATCH SIZE at fixed
    loop length — corroborates along an orthogonal axis;
  * the reference instead sums thread CPU ticks with clock()
    (main_mpi.c:1015-1081) — not comparable across thread counts.

Baseline: the reference's best published configuration — 20 ranks in pure
frame-parallel mode with MPI+OpenMP, 5.49e6 clock ticks ≈ 5.49 s CPU per
frame for the MMSE estimator alone (main_mpi.c:1053-1055; BASELINE.md) ⇒
0.1822 frames/s.  vs_baseline = our frames/s ÷ that.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# reference best: 20×1 frame-parallel MPI+OMP sweep row, 5.49e6 ticks/frame
# (main_mpi.c:1053-1055, CLOCKS_PER_SEC = 1e6)
BASELINE_FRAMES_PER_S = 1.0 / 5.49

PATH_LABELS = {"xla": "batch_major", "lane": "lane_major",
               "txconst": "lane_major_txconst",
               "txserve": "lane_major_txconst_serve",
               "txi8": "lane_major_txconst_i8_serve"}


def _device_fields(cpu: bool) -> dict:
    """Initialise JAX for this child and name its device; a missing GPU
    is an error unless ``cpu`` asks for a CPU rehearsal."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    devs = jax.devices()
    if devs[0].platform != "gpu" and not cpu:
        raise SystemExit(f"bench.py needs a GPU (JAX found "
                         f"{devs[0].platform!r}); pass --cpu to rehearse")
    from tpu80211.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if cpu:
        power = "n/a (cpu rehearsal)"
    else:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "power_limit": power}


def _gen(key, batch: int, dtype=None):
    """Synthesize a random batch-major Cplx frame batch on device."""
    import jax
    import jax.numpy as jnp

    from tpu80211 import constants as C
    from tpu80211.cplx import Cplx

    dtype = jnp.float32 if dtype is None else dtype
    ks = jax.random.split(key, 8)

    def cplx(k1, k2, shape):
        return Cplx(
            jax.random.normal(k1, shape, jnp.float32).astype(dtype),
            jax.random.normal(k2, shape, jnp.float32).astype(dtype),
        )

    return (
        cplx(ks[0], ks[1], (batch, C.PACKET_SAMPLES)),
        cplx(ks[2], ks[3], (batch, C.PACKET_SAMPLES)),
        cplx(ks[4], ks[5], (batch, C.PREAMBLE_SAMPLES)),
        cplx(ks[6], ks[7], (batch, C.PREAMBLE_SAMPLES)),
    )


def _next_s(checksum):
    """The serializing scalar, derived from a per-frame checksum."""
    import jax.numpy as jnp

    return jnp.tanh(jnp.sum(checksum)) * 1e-9


def _step(args, s, inc):
    """One serialized iteration of the batch-major chain: perturb inputs
    by (s + inc), run it, reduce to one scalar that feeds the next."""
    import jax
    import jax.numpy as jnp

    from tpu80211.pipeline import sc

    eps = s + inc
    # keep the storage dtype: bf16 * f32-scalar promotes to f32, which
    # would silently turn a bf16 run into an f32 chain
    args = jax.tree.map(lambda x: (x * (1.0 + eps)).astype(x.dtype), args)
    out = sc.rx_chain(*args)
    flat = jnp.stack(jax.tree.leaves(jax.tree.map(jnp.sum, out)))
    return jnp.tanh(jnp.sum(flat)) * 1e-9, out


def _step_lane(args, s, inc):
    """Serialized iteration through the lane-major entry; the fence reads
    its per-frame checksum."""
    from tpu80211.pipeline.lane import rx_chain_lane_major

    out = rx_chain_lane_major(*args, eps=s + inc)
    return _next_s(out["checksum"]), out


def _step_txconst(args, s, inc, **kw):
    """Serialized iteration through the tx-constant chain (``kw``:
    serve=True for the serving outputs)."""
    from tpu80211.pipeline.lane import rx_chain_txconst

    txs, tpre, rx_pkt, rx_lp, *lsb = args
    out = rx_chain_txconst(txs, tpre, rx_pkt, rx_lp, eps=s + inc,
                           lsb=lsb[0] if lsb else 1.0, **kw)
    return _next_s(out["checksum"]), out


def _marginal(step, iters, s0, incs, with_single=False):
    """Median-of-3 serialized loop-length marginal (module docstring);
    ``step(s, inc)`` returns (scalar, outputs).  ``with_single=True``
    also returns the best single-loop wall time."""
    def run(n):
        t0 = time.perf_counter()
        sv = s0
        for i in range(n):
            sv, _ = step(sv, incs[i])
        float(sv)
        return time.perf_counter() - t0

    reps = 3
    singles = []
    margins = []
    for _ in range(reps):
        t1 = run(iters)
        t2 = run(2 * iters)
        singles.append(t1 / iters)
        margins.append(max(t2 - t1, 1e-9))
    marg = sorted(margins)[reps // 2]
    if with_single:
        return marg, min(singles)
    return marg


def _bench_dense_mmse(iters: int = 24, batch: int = 8192) -> dict:
    """The op the reference actually times — the dense regularized 53×53
    solve (BASELINE.json configs[3]) — by batched Cholesky
    (ops/linalg.rank1_solve), serialized marginal methodology.  The
    solver's output is asserted against numpy before timing."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu80211.cplx import Cplx
    from tpu80211.ops.linalg import rank1_solve

    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    u = Cplx(jax.random.normal(ks[0], (batch, 53), jnp.float32),
             jax.random.normal(ks[1], (batch, 53), jnp.float32))
    rx = Cplx(jax.random.normal(ks[2], (batch, 53), jnp.float32),
              jax.random.normal(ks[3], (batch, 53), jnp.float32))
    ow2 = jnp.full((batch,), 0.37, jnp.float32)

    # arrays go in as arguments: captured, XLA would fold them into the
    # program as constants
    @jax.jit
    def step_a(u, rx, ow2, s, inc):
        z = rank1_solve(Cplx(u.re * (1.0 + s + inc), u.im), rx, ow2)
        return jnp.tanh(jnp.sum(z.re) + jnp.sum(z.im)) * 1e-9, z

    def step(s, inc):
        return step_a(u, rx, ow2, s, inc)

    got = np.asarray(rank1_solve(u, rx, ow2).to_complex())
    un = np.asarray(u.to_complex())
    rn = np.asarray(rx.to_complex())
    worst = 0.0
    for i in range(0, batch, max(1, batch // 7)):
        a = 0.37 * np.eye(53) + np.outer(un[i], np.conj(un[i]))
        want = np.linalg.solve(a, rn[i])
        worst = max(worst, float(np.abs(got[i] - want).max()
                                 / np.abs(want).max()))
    assert worst < 5e-5, ("dense mmse solve accuracy", worst)

    incs = [jnp.float32(1e-6 * i) for i in range(2 * iters)]
    s, _ = step(jnp.float32(0.0), incs[0])
    float(s)
    dt = _marginal(step, iters, s, incs)
    rate = batch * iters / dt
    return {
        "metric": "dense regularized 53x53 MMSE solve (batched Cholesky) "
                  "solves/s, serialized, gated",
        "unit": "solves/s",
        "value": round(rate, 1),
        "vs_baseline": round(rate / BASELINE_FRAMES_PER_S, 1),
        "batch": batch, "iters": iters,
        "gates": {"spot_rel_vs_numpy": worst},
    }


def _raw_workload(batch: int, ns: int = 2048, dtype=None):
    """B raw ns-sample streams, each carrying the shipped capture's frame
    at a random offset over 40 dB-down AWGN — the raw-sample stage the
    reference names but never builds (WiFi_RX.m:7 `threshold`)."""
    import jax.numpy as jnp
    import numpy as np

    from tpu80211 import constants as C
    from tpu80211.cplx import Cplx
    from tpu80211.datasets.loader import load_capture
    from tpu80211.ops.detect import lts_time_symbol
    from tpu80211.pipeline.lane import tx_spectra

    dtype = jnp.bfloat16 if dtype is None else dtype
    cap = load_capture()
    rng = np.random.default_rng(0)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((batch, ns))
         + 1j * rng.standard_normal((batch, ns))) * 1e-4
    offs = rng.integers(40, ns - 1400, batch)
    for i, o in enumerate(offs):
        x[i, o : o + 1360] += frame
    xt = np.ascontiguousarray(x.T)
    xc = Cplx(jnp.asarray(xt.real, dtype), jnp.asarray(xt.imag, dtype))
    lts = lts_time_symbol(cap.tx_lptot)
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    evm_den = float(np.sum(np.asarray(txs.re[:, :C.N_BLOCKS]) ** 2
                           + np.asarray(txs.im[:, :C.N_BLOCKS]) ** 2))
    return xc, offs, lts, txs, tpre, evm_den


def _bench_raw_system(iters: int = 24, batch: int = 32768,
                      stride: int = 16) -> dict:
    """Raw receiver (pipeline/raw.py): detect → align → 7-estimator
    chain, stride-decimated coarse metric.

    Correctness gates BEFORE timing, on the exact arrays the timed loop
    consumes: every stream detected, every detected start inside the
    [-4, -2] band the 4-sample advance targets, Σ|eq − tx|² EVM bounded,
    checksum finite."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu80211.cplx import Cplx
    from tpu80211.pipeline.raw import raw_rx_txconst

    x, offs, lts, txs, tpre, evm_den = _raw_workload(batch)
    # production equalizer (equalize_with="h_mmse"): the default
    # h_linear blend diverges on deep fades and is not the serving shape
    out = raw_rx_txconst(x, lts, txs, tpre, stream_sums=True,
                         equalize_with="h_mmse", stride=stride)
    det = np.asarray(out["detected"])
    err = np.asarray(out["start"]) - offs
    assert det.all(), ("raw system missed packets", int((~det).sum()))
    assert err.min() >= -4 and err.max() <= -2, (err.min(), err.max())
    assert np.isfinite(np.asarray(out["checksum"])).all()
    evm_rms = float(np.sqrt(np.asarray(out["evm_sums"]).sum()
                            / (batch * evm_den)))
    assert evm_rms < 0.1, ("raw system EVM", evm_rms)

    @jax.jit
    def step_x(xr, xi, lts, txs, tpre, s, inc):
        r = raw_rx_txconst(Cplx(xr, xi), lts, txs, tpre, eps=s + inc,
                           stream_sums=True, equalize_with="h_mmse",
                           stride=stride)
        return _next_s(r["checksum"]), r

    def step(s, inc):
        return step_x(x.re, x.im, lts, txs, tpre, s, inc)

    incs = [jnp.float32(1e-6 * i) for i in range(2 * iters)]
    s, _ = step(jnp.float32(0.0), incs[0])
    float(s)
    dt, single = _marginal(step, iters, s, incs, with_single=True)
    return {
        "metric": "raw receiver (detect+align+7-estimator chain) frames/s"
                  f" [stride {stride}], serialized, gated",
        "unit": "frames/s",
        "frames_per_s": round(batch * iters / dt, 1),
        "vs_baseline": round(batch * iters / dt / BASELINE_FRAMES_PER_S, 1),
        "ms_per_step": round(1e3 * dt / iters, 4),
        "ms_per_step_single_loop": round(1e3 * single, 4),
        "batch": batch,
        "iters": iters,
        "stride": stride,
        "gates": {
            "detect_rate": 1.0,
            "timing_err_band": [int(err.min()), int(err.max())],
            "evm_rms": round(evm_rms, 4),
        },
    }


def _bench_gen_raw_system(iters: int = 16, batch: int = 32768) -> dict:
    """Generative raw system (pipeline/raw.gen_raw_system): channel
    synthesis → waveform → placement → AWGN → detection → alignment →
    chain, nothing read from the host.

    Gates before timing: detection rate 1.0 at SNR 20, timing-in-band
    ≥ 0.85 (random dispersive channels legitimately shift fine timing
    within the CP), with the production equalizer
    (equalize_with="h_mmse") mean detected-stream EVM < 0.1 and RMS EVM
    < 0.1 over the streams without a deep fade (pipeline/raw.evm_stats),
    checksum finite.  The batch RMS EVM is reported beside them: over B
    Rayleigh draws it is set by the one or two deepest fades, not by the
    receiver."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu80211.cplx import Cplx
    from tpu80211.datasets.loader import load_capture
    from tpu80211.ops.detect import lts_time_symbol
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.raw import evm_stats, gen_raw_system

    cap = load_capture()
    lts = lts_time_symbol(Cplx.from_complex(cap.tx_lptot))
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))

    out = gen_raw_system(jnp.int32(7), batch, txs, tpre, lts,
                         equalize_with="h_mmse")
    det = np.asarray(out["detected"])
    err = np.asarray(out["start"]) - np.asarray(out["offsets"])
    in_band = (err >= -4) & (err <= -2)
    detect_rate = float(det.mean())
    in_band_rate = float(in_band.mean())
    assert detect_rate == 1.0, ("gen raw detect", detect_rate)
    assert in_band_rate >= 0.85, ("gen raw timing", in_band_rate)
    assert np.isfinite(np.asarray(out["checksum"])).all()
    ev = evm_stats(out, txs)
    assert ev["mean"] < 0.1, ("gen raw EVM", ev)
    assert ev["rms_no_deep_fade"] < 0.1, ("gen raw EVM", ev)

    @jax.jit
    def step_c(txs, tpre, lts, s, i):
        # serialization: the seed is data-dependent on the previous
        # step's checksum readback chain (stream.py's recipe)
        kseed = (jnp.asarray(7 + i, jnp.int32)
                 + (s * jnp.float32(1e9)).astype(jnp.int32))
        r = gen_raw_system(kseed, batch, txs, tpre, lts,
                           equalize_with="h_mmse")
        return _next_s(r["checksum"]), r

    def step(s, i):
        return step_c(txs, tpre, lts, s, i)

    incs = list(range(2 * iters))
    s, _ = step(jnp.float32(0.0), incs[0])
    float(s)
    dt, single = _marginal(step, iters, s, incs, with_single=True)
    return {
        "metric": "generative raw system (synthesize+detect+align+chain) "
                  "frames/s, serialized, gated",
        "unit": "frames/s",
        "frames_per_s": round(batch * iters / dt, 1),
        "vs_baseline": round(batch * iters / dt / BASELINE_FRAMES_PER_S, 1),
        "ms_per_step": round(1e3 * dt / iters, 4),
        "ms_per_step_single_loop": round(1e3 * single, 4),
        "batch": batch,
        "iters": iters,
        "snr_db": 20.0,
        "gates": {
            "detect_rate": detect_rate,
            "timing_in_band_rate": round(in_band_rate, 4),
            "evm_mean_detected": round(ev["mean"], 4),
            "evm_rms_no_deep_fade": round(ev["rms_no_deep_fade"], 4),
            "evm_rms_detected": round(ev["rms"], 4),
        },
    }


def _make_inputs(batch: int, dtype, lane: bool, txconst):
    import jax
    import jax.numpy as jnp

    from tpu80211.cplx import Cplx

    base = jax.jit(_gen, static_argnames=("batch", "dtype"))(
        jax.random.PRNGKey(0), batch, dtype
    )
    jax.block_until_ready(base)
    if lane:
        # lane-major layout: frame axis last
        base = jax.tree.map(lambda x: x.T, base)
    if txconst:
        from tpu80211.pipeline.lane import quantize_i8, tx_spectra

        tx_pkt, rx_pkt, tx_lp, rx_lp = base
        txs, tpre = tx_spectra(
            Cplx(tx_pkt.re[:, 0].astype(jnp.float32),
                 tx_pkt.im[:, 0].astype(jnp.float32)),
            Cplx(tx_lp.re[:, 0].astype(jnp.float32),
                 tx_lp.im[:, 0].astype(jnp.float32)),
        )
        if txconst == "i8":
            qp, lsb = quantize_i8(Cplx(rx_pkt.re.astype(jnp.float32),
                                       rx_pkt.im.astype(jnp.float32)))
            ql, _ = quantize_i8(Cplx(rx_lp.re.astype(jnp.float32),
                                     rx_lp.im.astype(jnp.float32)), lsb)
            base = (txs, tpre, qp, ql, lsb)
        else:
            base = (txs, tpre, rx_pkt, rx_lp)
    return base


def bench_chain(path: str, batch: int, iters: int, dtype) -> dict:
    """Measure one chain path with the full serialized + batch-marginal
    methodology.  ``path`` ∈ PATH_LABELS."""
    import functools

    import jax
    import jax.numpy as jnp

    lane = path != "xla"
    txconst = ("i8" if path == "txi8"
               else path in ("txconst", "txserve"))
    base = _make_inputs(batch, dtype, lane, txconst)
    fn = jax.jit({
        "xla": _step, "lane": _step_lane, "txconst": _step_txconst,
        "txserve": functools.partial(_step_txconst, serve=True),
        "txi8": functools.partial(_step_txconst, serve=True),
    }[path])
    incs = [jnp.float32(1e-6 * i) for i in range(2 * iters)]
    s, _ = fn(base, jnp.float32(0.0), incs[0])
    float(s)  # full warmup incl. readback path

    def run(n, args):
        t0 = time.perf_counter()
        sv = s
        for i in range(n):
            sv, _ = fn(args, sv, incs[i])
        float(sv)
        return time.perf_counter() - t0

    # repeat each marginal measurement and take the median
    reps = 3
    margins = sorted(
        max(run(2 * iters, base) - run(iters, base), 1e-9)
        for _ in range(reps)
    )
    dt = margins[reps // 2]  # marginal time of `iters` extra iterations
    frames_per_s = batch * iters / dt
    dt1 = run(iters, base)

    # SECOND, independent corroboration: marginal over BATCH SIZE at fixed
    # loop length — time the same loop at B and B/2 and attribute the
    # difference to the extra B/2 frames.
    half = _make_inputs(batch // 2, dtype, lane, txconst)
    s_half, _ = fn(half, jnp.float32(0.0), incs[0])
    float(s_half)
    bmargins = sorted(
        max(run(iters, base) - run(iters, half), 1e-9) for _ in range(reps)
    )
    frames_per_s_bmarg = (batch // 2) * iters / bmargins[reps // 2]

    bf16 = dtype == jnp.bfloat16
    row = {
        "value": round(frames_per_s, 1),
        "vs_baseline": round(frames_per_s / BASELINE_FRAMES_PER_S, 1),
        "batch": batch,
        "iters": iters,
        "dtype": "bf16" if bf16 else "f32",
        "path": PATH_LABELS[path],
        "wall_s": round(dt, 4),
        "wall_s_single_loop": round(dt1, 4),
        "frames_per_s_batch_marginal": round(frames_per_s_bmarg, 1),
        "fence_agreement": round(frames_per_s_bmarg / frames_per_s, 3),
    }
    row["metric"] = (
        "full-RX-chain (7 estimators incl. Wiener + blended equalization) "
        f"frames/s, single device, serialized [{row['path']}, "
        f"{'bf16-storage/f32-compute' if bf16 else 'f32'}]")
    row["unit"] = "frames/s"
    return row


def _child(flags: list[str], argv: list[str]) -> dict:
    """Measure one row in this process."""
    info = _device_fields("--cpu" in flags)
    import jax.numpy as jnp

    if "--dense" in flags:
        return {**_bench_dense_mmse(), **info}
    kw = {"batch": int(argv[0])} if argv else {}
    if len(argv) > 1:
        kw["iters"] = int(argv[1])
    if "--genraw" in flags:
        return {**_bench_gen_raw_system(**kw), **info}
    if "--raw" in flags or "--raw32" in flags:
        return {**_bench_raw_system(stride=32 if "--raw32" in flags else 16,
                                    **kw), **info}
    path = next((f[2:] for f in flags if f[2:] in PATH_LABELS), "lane")
    batch = kw.get("batch", 65536 if path.startswith("tx") else 32768)
    dtype = jnp.float32 if "--f32" in flags else jnp.bfloat16
    return {**bench_chain(path, batch, kw.get("iters", 48), dtype), **info}


# the default run: one child per row (args, key in the final line)
ROWS = (
    (["65536", "64", "--txconst"], None),
    (["32768", "48", "--lane"], "default_path"),
    (["65536", "64", "--txserve"], "serving_path"),
    (["65536", "64", "--txi8"], "i8_serving_path"),
    (["--raw"], "raw_system"),
    (["--raw32"], "raw_system_stride32"),
    (["--genraw"], "gen_raw_system"),
    (["--dense"], "dense_mmse"),
)


def main():
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    passthrough = [f for f in flags if f in ("--cpu", "--f32")]
    if set(flags) - {"--cpu", "--f32"} or argv:
        # one row, measured in this process
        print(json.dumps(_child(flags, argv)))
        return

    def run_sub(args):
        r = subprocess.run(
            [sys.executable, __file__, *args, *passthrough],
            capture_output=True, text=True, timeout=3600,
        )
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
            raise SystemExit(f"bench.py row {args} failed "
                             f"(exit {r.returncode})")
        return json.loads(r.stdout.strip().splitlines()[-1])

    result = None
    for args, key in ROWS:
        row = run_sub(args)
        if key is None:
            result = row
        else:
            row.pop("metric", None)
            row.pop("unit", None)
            result[key] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
