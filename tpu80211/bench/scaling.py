"""Scaling-efficiency benchmark — the analogue of the reference's
frame-group sweep (main_mpi.c:1032-1080, BASELINE.md).

Sweeps mesh shapes (dp × blk) over the available devices and reports
frames/s plus linear-scaling efficiency for the shard_map RX step.  On a
CPU host with XLA_FLAGS=--xla_force_host_platform_device_count=N this
exercises the same code that runs on N devices — the fake-backend
capability the reference lacks (its sweep needed a 20-slot LSF
allocation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu80211.cplx import Cplx
from tpu80211.datasets import synthetic
from tpu80211.parallel import make_mesh, pad_blocks, rx_step_shardmap
from tpu80211.utils.timing import timeit


def _inputs(batch: int, blk: int, nb_pad: int):
    with jax.default_device(jax.devices("cpu")[0]):
        fb = synthetic.generate(jax.random.PRNGKey(0), batch, dtype=jnp.complex64)
        txb = pad_blocks(np.asarray(fb.tx_symb), blk)[:, :nb_pad]
        rxb = pad_blocks(np.asarray(fb.rx_symb), blk)[:, :nb_pad]
        return (
            Cplx.from_complex(np.asarray(fb.tx_preamble_fft)),
            Cplx.from_complex(np.asarray(fb.rx_preamble_fft)),
            Cplx.from_complex(txb),
            Cplx.from_complex(rxb),
            jnp.asarray(np.asarray(fb.ow2)),
        )


def sweep(batch: int = 4096, iters: int = 5, shapes=None) -> list[dict]:
    """Returns one dict per (dp, blk) shape: frames/s and efficiency vs
    the single-device row scaled linearly."""
    n = len(jax.devices())
    if shapes is None:
        shapes = [(1, 1)] + [
            (d // b, b)
            for d in (n,)
            for b in (1, 2, 4)
            if d % b == 0 and d // b >= 1
        ]
    rows = []
    base_fps = None
    for dp, blk in shapes:
        ndev = dp * blk
        mesh = make_mesh(dp=dp, blk=blk, devices=jax.devices()[:ndev])
        step, nb_pad = rx_step_shardmap(mesh)
        args = _inputs(batch, blk, nb_pad)
        from tpu80211.parallel import frame_sharding

        args = jax.device_put(args, frame_sharding(mesh))
        dt = timeit(step, *args, iters=iters)
        fps = batch / dt
        if base_fps is None and ndev == 1:
            base_fps = fps
        eff = fps / (base_fps * ndev) if base_fps else None
        rows.append(
            {
                "dp": dp,
                "blk": blk,
                "devices": ndev,
                "frames_per_s": round(fps, 1),
                "ms_per_step": round(dt * 1e3, 3),
                "scaling_efficiency": round(eff, 3) if eff is not None else None,
            }
        )
    return rows


if __name__ == "__main__":
    import json

    for row in sweep():
        print(json.dumps(row))
