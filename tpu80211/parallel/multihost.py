"""Multi-host (multi-slice) initialization and hierarchical meshes.

Replaces the reference's cluster-launch layer — LSF `#BSUB` allocation +
`mpirun -np N -TCP -lsf` over 10 GbE (main_mpi.bash:1-30, C10) — with the
JAX distributed runtime:

  * each host process calls `init_distributed()` with the coordinator
    address, process count and rank, the analogue of `MPI_Init` +
    communicator setup (main_mpi.c:16-27);
  * `hierarchical_mesh()` builds a ('host', 'dp', 'blk') mesh whose outer
    axis spans hosts (the network) and inner axes span a host's devices
    (NVLink) — the reference's hybrid MPI×OpenMP topology (P7,
    utils.c:355-437, main_mpi.bash:9-11) expressed as named axes;
  * frames shard over ('host', 'dp') jointly, so scaling out hosts
    multiplies frame throughput with zero extra collective traffic (the
    only cross-host op is the final metrics psum).

This module cannot be exercised against real multi-host hardware in CI;
`tests/test_mesh.py` covers the same sharded code on a virtual 8-device
mesh, and `dryrun_multichip` compile-checks it per driver contract.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST, DP, BLK = "host", "dp", "blk"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Pass all three arguments for a multi-host run (the reference instead
    derived its world from `mpirun -np` + LSF host lists,
    main_mpi.bash:13-29); without them this is a single-process no-op.

    MUST run before any other JAX call: touching any JAX API (even
    `jax.process_count()`) initializes the XLA backend, after which
    `jax.distributed.initialize` refuses to run.  Failures are only
    swallowed for the implicit single-process case; with explicit
    multi-host arguments they re-raise — a silently-single-host "cluster"
    is the failure mode this guards against.
    """
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        # RuntimeError: backend already initialized / double init;
        # ValueError: cluster auto-detection found no coordinator (plain
        # single host) — 'coordinator_address should be defined.'
        already = "already initialized" in str(e).lower()
        if coordinator_address is not None and not already:
            raise  # explicit multi-host intent: do not degrade silently
        if not already:
            import warnings

            warnings.warn(
                f"jax.distributed.initialize unavailable ({e}); continuing "
                "single-process. Call init_distributed() before any other "
                "JAX API to enable multi-host.",
                stacklevel=2,
            )


def hierarchical_mesh(blk: int = 1) -> Mesh:
    """('host', 'dp', 'blk') mesh: hosts over the network, each host's
    devices over NVLink.

    With H hosts × L local devices: host axis length H, dp axis length
    L // blk.  Degenerates to (1, n, blk) on a single host.
    """
    n_local = jax.local_device_count()
    n_hosts = jax.process_count()
    assert n_local % blk == 0, (n_local, blk)
    devices = np.asarray(jax.devices()).reshape(n_hosts, n_local // blk, blk)
    return Mesh(devices, (HOST, DP, BLK))


def frame_sharding_mh(mesh: Mesh) -> NamedSharding:
    """Frames sharded jointly over ('host','dp'): batch axis splits across
    every chip in the job; all other axes replicated."""
    return NamedSharding(mesh, P((HOST, DP)))
