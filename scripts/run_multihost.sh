#!/usr/bin/env bash
# Multi-host launch template.  Replaces the reference's main_mpi.bash
# (LSF allocation + host-list construction + mpirun -np 15 -TCP -lsf,
# main_mpi.bash:1-30).
#
# Run THIS SAME SCRIPT on every host with, exported per host:
#   TPU80211_COORD=host0:8476  TPU80211_NPROC=<hosts>  TPU80211_PID=<rank>
# — no host lists, no slot counts, no communicator arithmetic
# (main_mpi.c:21-71).
set -euo pipefail
cd "$(dirname "$0")/.."

python - <<'PY'
import os
import jax
from tpu80211.parallel import multihost

multihost.init_distributed(
    coordinator_address=os.environ.get("TPU80211_COORD"),
    num_processes=int(os.environ["TPU80211_NPROC"]) if "TPU80211_NPROC" in os.environ else None,
    process_id=int(os.environ["TPU80211_PID"]) if "TPU80211_PID" in os.environ else None,
)
print(f"process {jax.process_index()}/{jax.process_count()}, "
      f"{jax.local_device_count()} local / {jax.device_count()} global devices")

mesh = multihost.hierarchical_mesh(blk=1)
print("mesh:", dict(mesh.shape))

# every host runs the same sharded program; frames split over all chips
from tpu80211.bench.scaling import sweep
for row in sweep(batch=4096, iters=5, shapes=[(jax.device_count(), 1)]):
    if jax.process_index() == 0:
        print(row)
PY
