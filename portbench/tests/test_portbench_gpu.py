"""A short run of ``dambreak3d.run`` on the card through the benchmark's
command: it prints the contract's line with ``correct`` true.  Skips where
no card is visible (decided in the fixture, never at import)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    cmd = [sys.executable, "portbench/run.py", "--workload", "dambreak3d.run",
           "--seed", str(2**31 + 12345), "--seconds", "10", "--trace", "1"]
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    res = json.loads(done.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert set(res["metrics"]) == {"step.device_ms_per_step", "step.graph_nodes_per_step",
                                   "cell_list.rebuilds_per_step", "block_sweep_roofline",
                                   "device.peak_gib"}
    assert 0 < res["metrics"]["block_sweep_roofline"]["value"] < 100
