"""bench.py smoke tests: a CPU rehearsal of one row, and the stage
script, guard the entry points against import/arg regressions."""

import json
import os
import subprocess
import sys


def test_bench_stages_runs_tiny(tmp_path):
    # TPU80211_ARTIFACTS_DIR: keep the smoke run out of the checkout's
    # artifacts/
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "TPU80211_ARTIFACTS_DIR": str(tmp_path)}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv=['bench_stages.py','64','2'];"
         "import runpy; runpy.run_path('scripts/bench_stages.py',"
         "run_name='__main__')"],
        capture_output=True, text=True, timeout=400, env=env, cwd=root,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()
             if x.startswith("{")]
    stages = [o["stage"] for o in lines if "stage" in o]
    assert stages == ["front_end", "lt_ls", "ps_linear", "ps_cubic",
                      "ps_sinc", "ps_spline", "ps_wiener", "ps_mmse_sm",
                      "equalize"]
    assert os.path.exists(os.path.join(str(tmp_path), "stage_costs.json"))


def test_bench_default_path_runs_tiny():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv=['bench.py','256','2','--cpu'];"
         "import bench; bench.main()"],
        capture_output=True, text=True, timeout=400, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    obj = json.loads(line)
    assert obj["unit"] == "frames/s"
    assert obj["value"] > 0
    assert "vs_baseline" in obj
    assert obj["platform"] == "cpu" and obj["device_count"] >= 1
    assert "cpu" in obj["power_limit"]


def test_bench_refuses_cpu_without_flag():
    """Without --cpu and without a GPU, a row fails instead of timing the
    CPU under a device label."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "bench.py", "256", "2"],
        capture_output=True, text=True, timeout=400, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
