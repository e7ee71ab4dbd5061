"""Trace reduction (tpu80211/utils/trace.py) and the path list of
scripts/trace_paths.py, at tiny sizes on the CPU."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest

from tpu80211.utils.trace import busy_ns, reduce_events, trace_steps

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 20)], 20.0),            # overlap
    ([(30, 40), (0, 10), (10, 15)], 25.0),  # unsorted, touching
    ([(0, 100), (10, 20), (30, 40)], 100.0),  # nested
])
def test_busy_ns_is_the_union(intervals, want):
    assert busy_ns(intervals) == want


def test_reduce_events_per_step_figures():
    # two steps of two ops; a 10 ns gap between the steps
    ev = [("gemm", 0, 30), ("fusion", 30, 10),
          ("gemm", 50, 30), ("fusion", 80, 10)]
    r = reduce_events(ev, steps=2)
    assert r["kernel_ms_per_step"] == pytest.approx(40e-6)
    assert r["busy_ms_per_step"] == pytest.approx(40e-6)
    assert r["busy_share_of_window"] == pytest.approx(80 / 90)
    assert [n for n, _, _ in r["top"]] == ["gemm", "fusion"]
    assert r["top"][0][2] == pytest.approx(0.75)
    assert reduce_events([], steps=3) == {"kernel_events": 0}


def test_trace_steps_without_gpu_reports_no_device_figure():
    r = trace_steps(lambda x: jnp.sin(x) * 2.0, jnp.ones((8,)), steps=2)
    assert r == {"device_plane": None}


def test_trace_paths_run_at_tiny_size():
    """Every path the trace script lists runs and returns finite arrays."""
    import numpy as np

    from scripts import trace_paths

    names = []
    for name, fn, args in trace_paths.paths(b1=64, b2=128, bd=16):
        out = jax.jit(fn)(*args)
        for leaf in jax.tree.leaves(out):
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                assert np.isfinite(np.asarray(leaf, np.float32)).all(), name
        names.append(name)
    assert names == ["chain_f32_batch_major", "txconst_bf16",
                     "txconst_bf16_serve", "raw_s16", "gen_raw",
                     "dense_solve"]
