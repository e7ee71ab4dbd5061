#!/usr/bin/env python
"""Trace three steps of every production path on one GPU at the
benchmark's sizes and print each path's device-time breakdown
(tpu80211/utils/trace.py): per-op device time per step and the busy
share of the traced window.

Usage: python scripts/trace_paths.py [--out FILE]
Prints one ``TRACE <path> {json}`` line per path, then the card's name
and power limit; ``--out`` also writes the lines to FILE.  Fails without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu80211.cplx import Cplx  # noqa: E402
from tpu80211.utils.compile_cache import enable_compile_cache  # noqa: E402
from tpu80211.utils.trace import trace_steps  # noqa: E402


def paths(b1: int = 32768, b2: int = 65536, bd: int = 8192):
    """(name, fn, args) of every production path, at bench.py's sizes."""
    from tpu80211.datasets import synthetic_sc
    from tpu80211.ops.linalg import rank1_solve
    from tpu80211.pipeline import sc
    from tpu80211.pipeline.lane import rx_chain_txconst
    from tpu80211.pipeline.raw import gen_raw_system, raw_rx_txconst

    _, txs, tpre, lts, _ = cs._capture_consts()
    frames = cs._time_frames(512)
    reps = -(-b1 // 512)
    chain = tuple(Cplx.from_complex(np.tile(f, (reps, 1))[:b1], jnp.float32)
                  for f in frames)
    yield "chain_f32_batch_major", sc.rx_chain, chain
    pkt, lp, _ = synthetic_sc.generate_rx_lane_major(
        jax.random.PRNGKey(3), b2, txs, tpre, snr_db=20.0,
        dtype=jnp.bfloat16)
    yield ("txconst_bf16",
           lambda t, u, a, b: rx_chain_txconst(t, u, a, b),
           (txs, tpre, pkt, lp))
    yield ("txconst_bf16_serve",
           lambda t, u, a, b: rx_chain_txconst(t, u, a, b, serve=True),
           (txs, tpre, pkt, lp))
    x, _, lts_, txs_, tpre_, _ = cs.raw_workload(b1)
    yield ("raw_s16",
           lambda xr, xi, lt, t, u: raw_rx_txconst(
               Cplx(xr, xi), lt, t, u, stream_sums=True,
               equalize_with="h_mmse"),
           (x.re, x.im, lts_, txs_, tpre_))
    yield ("gen_raw",
           lambda s, t, u, lt: gen_raw_system(s, b1, t, u, lt,
                                              equalize_with="h_mmse"),
           (jnp.int32(7), txs, tpre, lts))
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    u = Cplx(jax.random.normal(ks[0], (bd, 53)),
             jax.random.normal(ks[1], (bd, 53)))
    r = Cplx(jax.random.normal(ks[2], (bd, 53)),
             jax.random.normal(ks[3], (bd, 53)))
    yield "dense_solve", rank1_solve, (u, r, jnp.full((bd,), 0.37,
                                                      jnp.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the TRACE lines here")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("trace_paths.py needs a GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    lines = []
    for name, fn, fargs in paths():
        lines.append(f"TRACE {name} " + json.dumps(trace_steps(fn, *fargs)))
        print(lines[-1], flush=True)
    print(cs._card_line(), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
