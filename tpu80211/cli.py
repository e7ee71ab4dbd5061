"""Command-line driver: `python -m tpu80211 <command>`.

Replaces the reference's launch surface — `compile.c` argv selection,
`main_*.bash` LSF scripts, and estimator selection by (un)commenting code
(main.c:37-54) — with flags over one Config dataclass.

Commands:
  run        — run estimators on the shipped capture (the reference
               drivers' workload) and print H_EST per subcarrier
  bench      — frames/s of the full RX chain on synthetic frames
  parity     — compare the JAX paths against the native C++ oracle
  devices    — show the JAX backend / mesh that would be used
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu80211")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run estimators on the shipped capture")
    run.add_argument("--estimators", default="all",
                     help="comma list of lt_ls,ps_linear,ps_cubic,ps_sinc,"
                          "ps_spline,ps_mmse (default all)")
    run.add_argument("--mode", default="math",
                     choices=["math", "matlab", "c_parity"])
    run.add_argument("--avg-blocks", type=int, default=4)
    run.add_argument("--quiet", action="store_true",
                     help="print timing only, not the 53 CFR values")

    bench = sub.add_parser("bench", help="full-chain frames/s benchmark")
    bench.add_argument("--batch", type=int, default=32768)
    bench.add_argument("--iters", type=int, default=48)
    bench.add_argument("--xla", action="store_true",
                       help="batch-major chain (sc.rx_chain) instead of "
                            "the lane-major entry")
    bench.add_argument("--f32", action="store_true",
                       help="f32 storage instead of bf16")
    bench.add_argument("--txconst", action="store_true",
                       help="tx-constant production shape (shared known "
                            "transmit packet)")
    bench.add_argument("--txserve", action="store_true",
                       help="tx-constant SERVING shape (only "
                            "h_wiener/h_mmse/eq/sigma2/cfo written at "
                            "batch width)")
    bench.add_argument("--cpu", action="store_true",
                       help="CPU rehearsal (rows then say 'cpu'); without "
                            "it the benchmark requires a GPU")

    par = sub.add_parser("parity", help="JAX vs native C++ oracle check")
    par.add_argument("--mode", default="math",
                     choices=["math", "matlab", "c_parity"])

    st = sub.add_parser("stream", help="stream synthetic frames through the chain")
    st.add_argument("--batches", type=int, default=4)
    st.add_argument("--batch", type=int, default=1024)
    st.add_argument("--out-dir", default=None,
                    help="persist per-batch H_EST shards + resume cursor")
    st.add_argument("--snr-db", type=float, default=40.0)
    st.add_argument("--engine", default="native", choices=("native", "jax"),
                    help="host-side frame producer: the multithreaded C++ "
                         "data engine (default) or the JAX CPU generator")
    st.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    st.add_argument("--device-gen", action="store_true",
                    help="device-resident stream: synthesize frames ON the "
                         "device and run the tx-constant chain (persists "
                         "per-batch summaries + sampled estimates instead "
                         "of full H_EST shards)")
    st.add_argument("--channel-model", default=None,
                    choices=["A", "B", "C", "D", "E"],
                    help="ETSI BRAN power-delay profile for --device-gen")
    st.add_argument("--gen", default="kernel",
                    choices=["kernel", "xla", "raw"],
                    help="--device-gen generator: 'kernel' "
                         "(frequency-domain frames straight into the "
                         "estimators), 'xla' (time-domain generation + "
                         "tx-const chain) or 'raw' (the generative raw "
                         "system, pipeline/raw.gen_raw_system: raw sample "
                         "streams at random offsets → detect+align+chain "
                         "receiver)")

    sw = sub.add_parser("sweep", help="mesh-shape scaling sweep")
    sw.add_argument("--batch", type=int, default=4096)
    sw.add_argument("--iters", type=int, default=5)

    pl = sub.add_parser("plot", help="write CFR PNGs (the reference's "
                        "Real_Part/Imag_Part artifact family)")
    pl.add_argument("--out-prefix", default="artifacts/cfr")
    pl.add_argument("--mode", default="math",
                    choices=["math", "matlab", "c_parity"])

    sy = sub.add_parser("sync", help="CFO/CPE synchronization demo: impair "
                        "synthetic frames with a carrier frequency offset, "
                        "estimate + correct it (ops/cfo.py)")
    sy.add_argument("--batch", type=int, default=64)
    sy.add_argument("--fo-hz", type=float, default=20e3,
                    help="carrier frequency offset (the capture's generation "
                         "value, WiFi_RX.m:9)")
    sy.add_argument("--snr-db", type=float, default=40.0)
    sy.add_argument("--constellation", metavar="PNG",
                    help="write a before/after equalized-constellation "
                         "scatter to this path")

    qu = sub.add_parser("quality", help="estimator accuracy benchmark: "
                        "NMSE/EVM/BER vs SNR (the quantitative successor of "
                        "the reference's plot-PNG accuracy record)")
    qu.add_argument("--snrs", default="0,5,10,15,20,25,30,35,40",
                    help="comma-separated SNR points in dB")
    qu.add_argument("--batch", type=int, default=512)
    qu.add_argument("--png", default=None,
                    help="also write NMSE/BER-vs-SNR curves to this PNG")
    qu.add_argument("--storage-dtype", default=None, choices=["bf16", "f32"],
                    help="also sweep the split-complex production chain at "
                         "this storage dtype (the shipped bench "
                         "configuration) and overlay it in the PNG")
    qu.add_argument("--channel-model", default=None,
                    choices=["A", "B", "C", "D", "E"],
                    help="ETSI BRAN power-delay profile (the reference's "
                         "WiFi_RX.m:6 parameter; default: the legacy "
                         "rms-100ns profile)")
    qu.add_argument("--modulation", default="qpsk",
                    choices=["qpsk", "qam16", "qam64"],
                    help="data-subcarrier constellation (Gray-coded BER; "
                         "the reference is QPSK-only)")

    raw = sub.add_parser("raw", help="raw-sample-stream receiver demo: "
                         "synthesize streams with the capture embedded at "
                         "random offsets, run the detect+align+chain "
                         "receiver (pipeline/raw.py)")
    raw.add_argument("--batch", type=int, default=512,
                     help="number of streams")
    raw.add_argument("--ns", type=int, default=2048,
                     help="samples per stream (multiple of 64)")
    raw.add_argument("--noise-amp", type=float, default=1e-4,
                     help="AWGN amplitude under the embedded capture")
    raw.add_argument("--threshold", type=float, default=None,
                     help="detection threshold on the normalized metric "
                          "(default: ops/detect.py's 0.5)")
    raw.add_argument("--stride", type=int, default=16,
                     choices=[1, 16, 32, 64],
                     help="coarse Schmidl&Cox decimation stride (fine "
                          "timing stays full-resolution)")
    raw.add_argument("--seed", type=int, default=0)

    sub.add_parser("devices", help="show backend devices")
    return p


def _cmd_run(args) -> int:
    import jax.numpy as jnp

    from tpu80211.config import ESTIMATOR_NAMES, EstimatorMode
    from tpu80211.datasets.loader import load_capture
    from tpu80211.models import PS_ESTIMATORS, lt_ls, ps_mmse

    mode = EstimatorMode(args.mode)
    names = (
        ESTIMATOR_NAMES if args.estimators == "all"
        else tuple(args.estimators.split(","))
    )
    cap = load_capture()
    tx_pre = jnp.asarray(cap.tx_preamble_fft)
    rx_pre = jnp.asarray(cap.rx_preamble_fft)
    txb = jnp.asarray(cap.tx_symb)
    rxb = jnp.asarray(cap.rx_symb)
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)

    for name in names:
        t0 = time.perf_counter()
        if name == "lt_ls":
            h = h_lt
        elif name == "ps_mmse":
            h = ps_mmse(txb, rxb, cap.ow2, h_lt, mode=mode,
                        avg_blocks=args.avg_blocks)
        elif name in PS_ESTIMATORS:
            h = PS_ESTIMATORS[name](txb, rxb, mode=mode,
                                    avg_blocks=args.avg_blocks)
        else:
            print(f"unknown estimator {name!r}", file=sys.stderr)
            return 2
        h = np.asarray(h)
        dt = time.perf_counter() - t0
        print(f"# {name} ({mode.value}): {dt*1e3:.2f} ms")
        if not args.quiet:
            for i, v in enumerate(h):
                print(f"H_EST[{i}] = {v.real:+.10e} {v.imag:+.10e}i")
    return 0


def _cmd_bench(args) -> int:
    # repo-root bench.py is not part of the installed package; load it by
    # path so the console script works from any cwd
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    bench_path = root / "bench.py"
    if not bench_path.exists():
        print(f"bench.py not found at {bench_path}", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("tpu80211_bench", bench_path)
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)
    sys.argv = ["bench.py", str(args.batch), str(args.iters)]
    if args.xla:
        sys.argv.append("--xla")
    if args.f32:
        sys.argv.append("--f32")
    if args.txconst:
        sys.argv.append("--txconst")
    if args.txserve:
        sys.argv.append("--txserve")
    if args.cpu:
        sys.argv.append("--cpu")
    bench_mod.main()
    return 0


def _cmd_parity(args) -> int:
    import jax.numpy as jnp

    from tpu80211.config import EstimatorMode
    from tpu80211.datasets.loader import load_capture
    from tpu80211.models import lt_ls, ps_interp, ps_mmse
    from tpu80211.parity import oracle_native as nat

    mode = EstimatorMode(args.mode)
    cap = load_capture()
    report = {}

    def rel(a, b):
        a = np.asarray(a, np.complex128)
        b = np.asarray(b, np.complex128)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    h_lt_nat = nat.lt_ls(cap.tx_preamble_fft, cap.rx_preamble_fft, mode)
    h_lt_jax = lt_ls(jnp.asarray(cap.tx_preamble_fft),
                     jnp.asarray(cap.rx_preamble_fft), mode=mode)
    report["lt_ls"] = rel(h_lt_jax, h_lt_nat)
    for kind in ("linear", "cubic", "sinc", "spline"):
        got = ps_interp(jnp.asarray(cap.tx_symb), jnp.asarray(cap.rx_symb),
                        kind, mode=mode)
        want = nat.ps_interp(cap.tx_symb, cap.rx_symb, kind, mode)
        report[f"ps_{kind}"] = rel(got, want)
    got = ps_mmse(jnp.asarray(cap.tx_symb), jnp.asarray(cap.rx_symb),
                  cap.ow2, jnp.asarray(h_lt_nat), mode=mode)
    want = nat.ps_mmse(cap.tx_symb, cap.rx_symb, cap.ow2, h_lt_nat, mode)
    report["ps_mmse"] = rel(got, want)

    ok = all(v < 1e-6 for v in report.values())
    print(json.dumps({"mode": mode.value, "max_rel_err": report, "pass": ok}))
    return 0 if ok else 1


def _cmd_stream(args) -> int:
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from tpu80211.pipeline import stream

    if args.device_gen:
        res = stream.run_stream_device(
            args.batches, args.batch, snr_db=args.snr_db,
            out_dir=args.out_dir, channel_model=args.channel_model,
            gen=args.gen,
        )
    else:
        res = stream.run_stream(
            stream.synthetic_batches(args.batches, args.batch,
                                     snr_db=args.snr_db, engine=args.engine),
            out_dir=args.out_dir,
        )
    print(json.dumps(res))
    return 0


def _cmd_sweep(args) -> int:
    from tpu80211.bench.scaling import sweep

    for row in sweep(batch=args.batch, iters=args.iters):
        print(json.dumps(row))
    return 0


def _cmd_plot(args) -> int:
    import pathlib

    import jax.numpy as jnp

    from tpu80211.config import EstimatorMode
    from tpu80211.datasets.loader import load_capture
    from tpu80211.models import lt_ls, ps_interp, ps_mmse
    from tpu80211.utils.plots import plot_cfr

    mode = EstimatorMode(args.mode)
    cap = load_capture()
    tx_pre = jnp.asarray(cap.tx_preamble_fft)
    rx_pre = jnp.asarray(cap.rx_preamble_fft)
    txb = jnp.asarray(cap.tx_symb)
    rxb = jnp.asarray(cap.rx_symb)
    h_lt = lt_ls(tx_pre, rx_pre, mode=mode)
    ests = {"LT-LS": np.asarray(h_lt)}
    for kind in ("linear", "cubic", "sinc", "spline"):
        ests[f"PS-{kind}"] = np.asarray(ps_interp(txb, rxb, kind, mode=mode))
    ests["PS-MMSE"] = np.asarray(ps_mmse(txb, rxb, cap.ow2, h_lt, mode=mode))

    pathlib.Path(args.out_prefix).parent.mkdir(parents=True, exist_ok=True)
    paths = plot_cfr(ests, args.out_prefix,
                     title=f"CFR estimates ({mode.value} mode)")
    # the LTS-only pair mirrors Real_Part_LTS.png / Imag_Part_LTS.png
    paths += plot_cfr({"LT-LS": ests["LT-LS"]}, args.out_prefix + "_lts",
                      title=f"LT-LS CFR ({mode.value} mode)")
    for pth in paths:
        print(pth)
    return 0


def _cmd_sync(args) -> int:
    import jax
    import jax.numpy as jnp

    from tpu80211 import constants as C
    from tpu80211.cplx import Cplx
    from tpu80211.datasets import synthetic
    from tpu80211.ops import cfo
    from tpu80211.pipeline import sc

    eps_true = args.fo_hz / 20e6
    fb = synthetic.generate(jax.random.PRNGKey(11), args.batch,
                            snr_db=args.snr_db)

    def c(x):
        return Cplx.from_complex(np.asarray(x), jnp.float32)

    tx_pkt = c(synthetic.synthesize_time(fb.tx_symb))
    rx_pkt = c(synthetic.apply_time_cfo(
        synthetic.synthesize_time(fb.rx_symb), eps_true,
        start=C.PREAMBLE_SAMPLES))
    tx_lp = c(synthetic.synthesize_preamble_time(fb.tx_preamble_fft))
    rx_lp = c(synthetic.apply_time_cfo(
        synthetic.synthesize_preamble_time(fb.rx_preamble_fft), eps_true))

    eps_hat = float(np.mean(np.asarray(cfo.estimate_cfo(rx_lp))))
    tx = np.asarray(fb.tx_symb)
    mask = np.asarray(C.DATA_MASK)

    def run(sync):
        out = sc.rx_chain(tx_pkt, rx_pkt, tx_lp, rx_lp,
                          equalize_with="h_mmse", sync=sync)
        eq = out.eq.to_complex()
        return eq, float(np.median(np.abs(eq - tx)[..., mask]))

    eq_raw, err_raw = run(False)
    eq_sync, err_sync = run(True)
    result = {
        "fo_hz_true": args.fo_hz,
        "fo_hz_estimated": eps_hat * 20e6,
        "median_symbol_err_uncorrected": round(err_raw, 5),
        "median_symbol_err_sync": round(err_sync, 5),
    }
    if getattr(args, "constellation", None):
        from tpu80211.utils.plots import plot_constellation

        qpsk = (np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j])
                / np.sqrt(2.0))
        result["constellation_png"] = plot_constellation(
            {
                f"uncorrected ({args.fo_hz/1e3:g} kHz CFO)":
                    np.asarray(eq_raw)[..., mask],
                "after CFO derotation + pilot CPE":
                    np.asarray(eq_sync)[..., mask],
            },
            args.constellation, ref_points=qpsk,
        )
    print(json.dumps(result))
    return 0


def _cmd_quality(args) -> int:
    from tpu80211.bench import quality

    snrs = [float(s) for s in args.snrs.split(",") if s.strip()]
    rows = quality.quality_sweep(snrs, batch=args.batch,
                                 channel_model=args.channel_model,
                                 modulation=args.modulation)
    for row in rows:
        print(json.dumps(row))
    storage_rows = None
    if args.storage_dtype:
        import jax.numpy as jnp

        dt = {"bf16": jnp.bfloat16, "f32": jnp.float32}[args.storage_dtype]
        storage_rows = quality.quality_sweep_storage(
            snrs, batch=min(args.batch, 256), dtype=dt
        )
        for row in storage_rows:
            print(json.dumps(row))
    if args.png:
        import pathlib

        pathlib.Path(args.png).parent.mkdir(parents=True, exist_ok=True)
        print(quality.plot_quality(rows, args.png,
                                   storage_rows=storage_rows))
    return 0


def _cmd_raw(args) -> int:
    """Raw-stream receiver demo: streams in, detection + estimates out."""
    import json as _json

    import jax.numpy as jnp

    from tpu80211.cplx import Cplx
    from tpu80211.datasets.loader import load_capture
    from tpu80211.ops.detect import lts_time_symbol
    from tpu80211.pipeline.lane import tx_spectra
    from tpu80211.pipeline.raw import raw_rx_txconst

    b = args.batch
    ns = args.ns
    assert ns % 64 == 0, "--ns must be a multiple of 64"
    # offsets are drawn from [40, ns-1400) and the 1360-sample frame is
    # embedded at offset+1360 <= ns; 1472 (= 23*64) is the smallest
    # multiple of 64 leaving that draw range non-empty (offsets in
    # [40, 72), frame end <= 71+1360 = 1431 <= 1472)
    assert ns >= 1472, (
        f"--ns {ns} too short: need >= 1472 samples "
        "(40-sample min offset + 1360-sample frame + draw margin)")
    cap = load_capture()
    rng = np.random.default_rng(args.seed)
    frame = np.concatenate([cap.rx_lptot, cap.rx_packet])
    x = (rng.standard_normal((b, ns))
         + 1j * rng.standard_normal((b, ns))) * args.noise_amp
    offs = rng.integers(40, ns - 1400, b)
    for i, o in enumerate(offs):
        x[i, o : o + 1360] += frame
    xc = Cplx.from_complex(np.ascontiguousarray(x.T), jnp.float32)
    lts = lts_time_symbol(cap.tx_lptot)
    lts = Cplx(jnp.asarray(lts.re, jnp.float32),
               jnp.asarray(lts.im, jnp.float32))
    txs, tpre = tx_spectra(Cplx.from_complex(cap.tx_packet, jnp.float32),
                           Cplx.from_complex(cap.tx_lptot, jnp.float32))
    t0 = time.perf_counter()
    out = raw_rx_txconst(xc, lts, txs, tpre, threshold=args.threshold,
                         stride=args.stride)
    err = np.asarray(out["start"]) - offs
    dt = time.perf_counter() - t0
    det = np.asarray(out["detected"])
    print(_json.dumps({
        "streams": b, "ns": ns,
        "detected": int(det.sum()),
        "timing_err_min": int(err[det].min()) if det.any() else None,
        "timing_err_max": int(err[det].max()) if det.any() else None,
        "metric_mean": round(float(np.asarray(out["metric"]).mean()), 4),
        "h_mmse_mean_abs": round(
            float(np.abs(np.asarray(out["h_mmse"].re)).mean()), 6),
        "wall_s": round(dt, 3),
        "note": "wall_s includes compile on first run; see "
                "bench.py --raw for throughput",
    }))
    return 0


def _cmd_devices(_args) -> int:
    import jax

    for d in jax.devices():
        print(d)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd in ("run", "parity", "plot"):
        # the reference-parity commands compare against the 80-bit oracle
        # at f64, which runs on the CPU (the GPU's f64 rate is not what
        # these commands are for)
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    return {
        "run": _cmd_run,
        "bench": _cmd_bench,
        "parity": _cmd_parity,
        "stream": _cmd_stream,
        "sweep": _cmd_sweep,
        "plot": _cmd_plot,
        "sync": _cmd_sync,
        "quality": _cmd_quality,
        "raw": _cmd_raw,
        "devices": _cmd_devices,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
