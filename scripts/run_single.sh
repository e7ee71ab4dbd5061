#!/usr/bin/env bash
# Single-host run: tests on the virtual 8-device CPU mesh, then the
# on-card smoke test and benchmark.  Replaces the reference's
# main_openmp.bash (LSF #BSUB + OMP_NUM_THREADS env,
# main_openmp.bash:1-14) — there is no thread-count tuning to do; XLA
# owns the device.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== tests (virtual 8-device CPU mesh) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "== parity vs native C++ oracle =="
python -m tpu80211.cli parity --mode math
python -m tpu80211.cli parity --mode c_parity

echo "== on-card smoke test + benchmark (one GPU) =="
python chip_smoke.py
python bench.py
