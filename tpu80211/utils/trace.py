"""Device-time breakdown of a jitted step from a ``jax.profiler`` trace.

``trace_steps`` runs a few steps of a function under the profiler and
reduces the first GPU plane's kernel events (``reduce_events``) to:

* ``kernel_ms_per_step`` — summed kernel time per step;
* ``busy_ms_per_step`` / ``busy_share_of_window`` — the union of kernel
  intervals per step, and its share of the window from the first kernel
  to the last: how far the host leaves the device idle between steps;
* ``top`` — the ops with the most device time, as (name, ms per step,
  share of kernel time).

PERF.md's "Where the time goes" reads these; scripts/trace_paths.py
traces every production path.
"""

from __future__ import annotations

import glob
import tempfile

import jax


def busy_ns(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def reduce_events(events, steps: int, top: int = 14) -> dict:
    """Fold (name, start_ns, duration_ns) kernel events of ``steps``
    steps into the module's per-step figures."""
    per_op, ivs = {}, []
    for name, start, dur in events:
        per_op[name] = per_op.get(name, 0.0) + dur
        ivs.append((start, start + dur))
    if not ivs:
        return {"kernel_events": 0}
    busy = busy_ns(ivs)
    window = max(e for _, e in ivs) - min(s for s, _ in ivs)
    tot = sum(per_op.values())
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "kernel_ms_per_step": tot / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "window_ms": window / 1e6,
        "busy_share_of_window": busy / window if window else None,
        "top": [(n, d / 1e6 / steps, d / tot) for n, d in ranked],
    }


def device_events(xplane_path: str):
    """Kernel events (name, start_ns, duration_ns) on the stream lines of
    the trace's first GPU plane, or None when it has no GPU plane."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        return None
    return [(ev.name, ev.start_ns, ev.duration_ns)
            for line in planes[0].lines if "stream" in line.name.lower()
            for ev in line.events]


def trace_steps(fn, *args, steps: int = 3) -> dict:
    """Compile and warm ``fn``, trace ``steps`` calls and reduce them.
    Without a GPU plane in the trace the result says so and holds no
    device figure."""
    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(steps):
                out = jf(*args)
            jax.block_until_ready(out)
        paths = glob.glob(f"{d}/**/*.xplane.pb", recursive=True)
        events = device_events(paths[0]) if paths else None
    if events is None:
        return {"device_plane": None}
    return reduce_events(events, steps)
