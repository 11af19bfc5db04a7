"""The plain reference against the port's plain CPU path: the same coarse
deck, the same arrays, float64 on both sides, until the first lazy
rebuilds; the two agree to rounding."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import sph
from portbench.tests.coarse import coarse_cell


@pytest.mark.parametrize("workload,t_out", [("dambreak3d.run", 0.003),
                                             ("movingsquare.run", 0.06)])
def test_reference_matches_the_port_in_float64(workload, t_out):
    c = coarse_cell(workload)
    cfg = c["config"]
    if cfg["deck"] == "dam_break_3d":            # dx 0.03, as the benchmark's test case
        dx = 0.03
        cfg["geometry"]["dx"] = dx
        cfg["constants"].update(dx=dx, m0=1000 * dx**3)
        cfg["kernel"]["h"] = np.sqrt(3) * dx
    cfg["run"]["dtype"] = "float64"
    arrays = harness.deck_arrays(cfg, 2**31 + 99)
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    out = sim.interval_fn(sim.state, t_out)
    got = check.port_numpy(out)
    ref, steps = check.reference_interval(cfg, arrays, None, t_out, 1000, device="cpu")
    assert steps == got["iteration"] > 5
    gaps = check.gaps(got, ref, got["iteration"], steps, sph.physics(cfg))
    assert gaps["steps"] == 0
    for name in ("pos_gap", "vel_gap", "rho_gap"):
        assert gaps[name] < 1e-9, (name, gaps)
    if cfg["motion"]:
        assert int(out.rebuilds) >= 2               # lazy rebuilds inside the interval


def test_reference_from_a_program_state_in_its_row_order():
    """The later interval starts from the program's own state, rows as it
    holds them: one more interval from there agrees to rounding too."""
    c = coarse_cell("movingsquare.run")
    cfg = c["config"]
    cfg["run"]["dtype"] = "float64"
    arrays = harness.deck_arrays(cfg, 41)
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    mid = sim.interval_fn(sim.state, 0.03)
    end = sim.interval_fn(mid, 0.06)
    start = dict(check.port_numpy(mid), order=mid.particles.id.long().numpy() - 1)
    ref, steps = check.reference_interval(cfg, arrays, start, 0.06, 1000, device="cpu")
    got = check.port_numpy(end)
    gaps = check.gaps(got, ref, got["iteration"] - start["iteration"], steps, sph.physics(cfg))
    assert gaps["steps"] == 0 and max(gaps.values()) < 1e-9, gaps


@pytest.mark.parametrize("workload", ["dambreak3d.run", "movingsquare.run"])
def test_drift_from_t0(workload):
    # the program (float32) and the float32 witness against the float64
    # reference, all three from the deck's initial arrays to output 3
    from portbench.drift import drift

    res = drift(coarse_cell(workload), 2**31 + 11, 3, "cpu")
    assert res["steps"] == res["reference_steps"] == res["witness_steps"] > 5
    limits = coarse_cell(workload)["config"]["check"]["limits"]
    for side in ("program", "witness"):
        for field in ("pos_gap", "vel_gap", "rho_gap"):
            assert 0 < res[side][field] <= limits[f"later.{field}"]
