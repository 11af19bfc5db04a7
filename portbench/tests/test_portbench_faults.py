"""A whole run of the harness on the CPU at a coarse size, past its look for
a card: sound, ``correct`` is true; with the timed path broken underneath,
or the control (the reference in bfloat16) in the program's place, it is
false.  The faults a cell can have: a step that hands its state back
unchanged, half of the rows left out, an answer altered where it is
produced."""

import io
import json
import time

import pytest

from portbench import harness
from portbench.tests.coarse import coarse_cell


def run(workload, fault=None, control=None, seed=2**31 + 5, seconds=2.5, trace=False):
    out = io.StringIO()
    rc = harness.run_cell(workload, seed, seconds, trace, time.perf_counter(), device="cpu",
                          fault=fault, control=control, c=coarse_cell(workload), out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["dambreak3d.run", "movingsquare.run"])
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert "later.pos_gap" in res["checks"]
    assert list(res)[-1] == "checks"
    want = {"dambreak3d.run": {"particle_steps_per_s", "interval_s_p95"},
            "movingsquare.run": {"particle_steps_per_s.square", "interval_s_p95.square"}}[workload]
    assert set(res["metrics"]) == want | {"setup_s"}


@pytest.mark.parametrize("workload,metric", [("dambreak3d.run", "cell_list.rebuilds_per_step"),
                                             ("movingsquare.run",
                                              "cell_list.rebuilds_per_step.square")])
def test_traced_run_reads_what_it_can(workload, metric):
    # on the CPU there is no profiler trace, chunk graph or device memory:
    # those metrics are left out, the rebuild counter reads
    res = run(workload, trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {metric} and res["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("dambreak3d.run", "unchanged"), ("dambreak3d.run", "half"), ("dambreak3d.run", "altered"),
    ("movingsquare.run", "unchanged"), ("movingsquare.run", "half"),
    ("movingsquare.run", "altered")])
def test_broken_path_is_not_correct(workload, fault):
    assert run(workload, fault=fault)["correct"] is False


@pytest.mark.parametrize("workload", ["dambreak3d.run", "movingsquare.run"])
def test_control_is_not_correct(workload):
    res = run(workload, control="bfloat16")
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
