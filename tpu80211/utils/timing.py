"""Timing / profiling harness — the structured replacement for the
reference's observability story.

The reference brackets estimator calls with `clock()` and hand-pastes the
tick counts into a source comment (main.c:40-45, main_mpi.c:98-104, the
results table at main_mpi.c:1015-1081), with printf progress lines as
tracing (utils.c:314).  Here:

  * `timeit` — wall-clock timing with `jax.block_until_ready` fences
    (dispatch-ordering replaces MPI_Barrier; wall-clock replaces the
    thread-summed CPU ticks that make the reference's OpenMP numbers
    incomparable, SURVEY.md §6);
  * `Report` — structured JSON accumulation (frames/s, per-stage ms,
    scaling efficiency) instead of comment blocks;
  * `roofline` — back-of-envelope FLOP/byte accounting for a pipeline
    stage vs. the device's published peaks (`DEVICE_PEAKS`);
  * device-time breakdowns from a profiler trace live in utils/trace.py.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

import jax


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kw) -> float:
    """Mean wall-clock seconds per call, fenced with
    ``jax.block_until_ready``.  Identical args every iteration: for a
    benchmark-grade number use bench.py's serialized-dependency
    methodology."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@dataclasses.dataclass
class Report:
    """Accumulates named measurements; serializes to one JSON object."""

    meta: dict = dataclasses.field(default_factory=dict)
    entries: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, **fields: Any) -> None:
        self.entries[name] = fields

    def json(self) -> str:
        return json.dumps({"meta": self.meta, **self.entries})

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.json() + "\n")


# Published peaks per device, keyed by ``jax.devices()[0].device_kind``:
# NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
# card's full 700 W power limit (a card set lower cannot hold its top
# clock under load — report its power limit beside any roofline share).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tflops": {"bf16": 989.0, "fp16": 989.0, "tf32": 495.0,
                   "f32": 67.0, "fp8": 1979.0, "int8": 1979.0},
        "hbm_gb_s": 3350.0,
        "nvlink_gb_s_each_way": 450.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak table row for ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak figures for device kind {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}") from None


def roofline(flops: float, bytes_moved: float, device_kind: str,
             dtype: str = "f32") -> dict:
    """Attainable time bounds for a stage moving `bytes_moved` device-
    memory bytes and doing `flops` flops at ``dtype``'s peak rate."""
    peaks = device_peaks(device_kind)
    t_compute = flops / (peaks["tflops"][dtype] * 1e12)
    t_memory = bytes_moved / (peaks["hbm_gb_s"] * 1e9)
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "intensity_flop_per_byte": flops / max(bytes_moved, 1.0),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "bound": "compute" if t_compute > t_memory else "memory",
        "t_light_s": max(t_compute, t_memory),
    }


def rx_chain_cost(batch: int) -> dict:
    """FLOP/byte model of the split-complex full RX chain per invocation.

    Dominant terms: block-extraction DFT matmuls (2 packets ×
    (B·15,64)@(64,53) × 4 real matmuls) and the elementwise estimator /
    equalizer work; see pipeline/sc.py.
    """
    from tpu80211 import constants as C

    b = batch
    dft = 2 * b * C.N_BLOCKS * C.N_FFT * C.N_SC * 2 * 4  # 2 pkts, 4 real mm
    mmse_dft = 2 * b * C.N_SC * C.N_SC * 2 * 4
    elementwise = 40 * b * C.N_BLOCKS * C.N_SC  # LS/SM/equalize, ~40 flop/elt
    flops = dft + mmse_dft + elementwise
    bytes_in = b * (2 * C.PACKET_SAMPLES + 2 * C.PREAMBLE_SAMPLES) * 2 * 4
    bytes_out = b * (C.N_BLOCKS * C.N_SC + 6 * C.N_SC) * 2 * 4
    return {"flops": flops, "bytes": bytes_in + bytes_out}
