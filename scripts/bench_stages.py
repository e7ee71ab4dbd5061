#!/usr/bin/env python
"""Measured per-stage cost decomposition of the (unfused) XLA RX chain.

Round 1's per-stage table came from `timeit` with re-fed identical args,
which this runtime's caching makes a lower bound at best (VERDICT.md
round-1 weak#6).  This script measures each stage as the MARGINAL cost
between consecutive chain PREFIXES, each prefix timed with the full
serialized methodology (data-dependent loop + readback fence +
loop-length marginal, see bench.py).  Because XLA fuses across stage
boundaries, a prefix-marginal is the honest per-stage attribution: it
charges each stage with exactly the extra work its presence adds to the
compiled program, including any fusion it breaks.

Usage: python scripts/bench_stages.py [batch] [iters]
Writes artifacts/stage_costs.json.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

from tpu80211.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp

import bench
from tpu80211.pipeline import sc

# chain prefixes: (name, number of stages included).  Stage list mirrors
# sc.rx_chain / rx_chain_freq (pipeline/sc.py:244-309).
STAGES = [
    "front_end",   # preamble FFTs + noise power + block extraction
    "lt_ls",
    "ps_linear",
    "ps_cubic",
    "ps_sinc",
    "ps_spline",
    "ps_wiener",
    "ps_mmse_sm",
    "equalize",
]


def prefix_chain(args, n_stages: int):
    tx_pkt, rx_pkt, tx_lp, rx_lp = args
    outs = []
    tx_pre = sc.preamble_fft(tx_lp)
    rx_pre = sc.preamble_fft(rx_lp)
    ow2 = sc.noise_power(rx_lp)
    txb = sc.extract_blocks(tx_pkt)
    rxb = sc.extract_blocks(rx_pkt)
    outs += [tx_pre, rx_pre, txb, rxb, ow2]
    h_lt = h_lin = None
    steps = iter(range(1, len(STAGES)))
    for i in steps:
        if i >= n_stages:
            break
        name = STAGES[i]
        if name == "lt_ls":
            h_lt = sc.lt_ls(tx_pre, rx_pre)
            outs.append(h_lt)
        elif name.startswith("ps_") and name != "ps_mmse_sm":
            h = sc.ps_interp(txb, rxb, name.removeprefix("ps_"))
            if name == "ps_linear":
                h_lin = h
            outs.append(h)
        elif name == "ps_mmse_sm":
            outs.append(sc.ps_mmse_sm(txb, rxb, ow2, h_lt))
        elif name == "equalize":
            outs.append(sc.equalize(rxb, h_lt, h_lin))
    flat = jnp.stack([jnp.sum(o.re) + jnp.sum(o.im) if hasattr(o, "re")
                      else jnp.sum(o) for o in outs])
    return jnp.tanh(jnp.sum(flat)) * 1e-9


REPEATS = 3


def time_prefix(base, n_stages: int, iters: int) -> tuple[float, float]:
    """Median and spread (max−min) of REPEATS independent loop-marginal
    measurements of the n-stage prefix, seconds per step."""

    @jax.jit
    def step(args, s, inc):
        eps = s + inc
        args = jax.tree.map(lambda x: x * (1.0 + eps), args)
        return prefix_chain(args, n_stages)

    incs = [jnp.float32(1e-6 * i) for i in range(2 * iters)]
    s = step(base, jnp.float32(0.0), incs[0])
    float(s)

    def run(n):
        t0 = time.perf_counter()
        sv = s
        for i in range(n):
            sv = step(base, sv, incs[i])
        float(sv)
        return time.perf_counter() - t0

    vals = sorted(
        max(run(2 * iters) - run(iters), 1e-9) / iters for _ in range(REPEATS)
    )
    return vals[REPEATS // 2], vals[-1] - vals[0]


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    base = jax.jit(bench._gen, static_argnames=("batch", "dtype"))(
        jax.random.PRNGKey(0), batch, jnp.float32
    )
    jax.block_until_ready(base)

    rows, prev, prev_spread = [], 0.0, 0.0
    for n in range(1, len(STAGES) + 1):
        dt, spread = time_prefix(base, n, iters)
        # a stage marginal is the difference of two noisy prefix medians:
        # it is only signal when it clears the jitter of BOTH prefixes.
        # Publish null (with the jitter bound) otherwise — never a
        # negative or sub-jitter number presented as cost (ADVICE round-2)
        marginal = dt - prev
        jitter = max(spread, prev_spread)
        row = {
            "stage": STAGES[n - 1],
            "prefix_ms": round(1e3 * dt, 4),
            "prefix_spread_ms": round(1e3 * spread, 4),
            "repeats": REPEATS,
            "marginal_ms": (round(1e3 * marginal, 4)
                            if marginal > jitter else None),
        }
        if row["marginal_ms"] is None:
            row["marginal_below_jitter_ms"] = round(1e3 * jitter, 4)
        rows.append(row)
        print(json.dumps(row))
        prev, prev_spread = dt, spread
    d = jax.devices()
    out = {"platform": d[0].platform, "device_kind": d[0].device_kind,
           "device_count": len(d), "batch": batch, "iters": iters,
           "rows": rows}
    import os
    path = pathlib.Path(
        os.environ.get("TPU80211_ARTIFACTS_DIR")
        or pathlib.Path(__file__).resolve().parents[1] / "artifacts")
    path.mkdir(exist_ok=True)
    (path / "stage_costs.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"wrote": str(path / "stage_costs.json")}))


if __name__ == "__main__":
    main()
