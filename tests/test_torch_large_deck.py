"""The 2,215,035-row 3D dam break of the benchmark (``dambreak3d_large.run``,
``portbench/configs/dambreak3d_dx0.0034.json``) on the CPU, without JAX:

* the cell resolves, its deck has the configuration's rows, past the block
  sweep's cap, so the driver routes it to the cell sweep B3;
* the metrics it reports: the dam break's end-to-end ones and the five
  ``.large`` per-layer ones, no B1 roofline;
* the reader of B3's time per launch on synthetic traces;
* a coarse copy of the deck on the cell route (the cap lowered below its
  rows), through ``harness.build_port`` and one interval in float64, against
  the benchmark's plain reference (``check.reference_interval``).
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402
from portbench.reference import sph  # noqa: E402
from sphexample_tpu_torch.core import driver  # noqa: E402

CELL = "dambreak3d_large.run"
LARGE = ("step.device_ms_per_step", "step.graph_nodes_per_step",
         "cell_list.rebuilds_per_step", "device.peak_gib")
B3 = "cell_sweep.ms_per_launch.large"


def reader(name):
    return harness.load_module(harness.find("metrics", name, ".py")).read


def test_the_cell_resolves_and_its_deck_takes_the_cell_sweep():
    c = harness.cell(CELL)
    cfg = c["config"]
    assert c["workload"]["chips"] == 1 and cfg["name"] == "dambreak3d_dx0.0034"
    assert cfg["geometry"]["dx"] == cfg["constants"]["dx"] == 0.0034
    assert cfg["constants"]["m0"] == pytest.approx(1000 * 0.0034**3, rel=1e-12)
    assert cfg["kernel"]["h"] == pytest.approx(3**0.5 * 0.0034, rel=1e-15)
    pos, rho, ptype, marker, ids = harness.deck_arrays(cfg, 3000000019)
    rows = len(pos)
    assert rows == cfg["particles"] == 2215035 > driver.BLOCK_CAP_LIMIT
    assert int((ptype == 1).sum()) == 1947756
    assert driver.choose_sweep_kernel(True, rows) == "cell"
    assert driver.choose_sweep_kernel(True, harness.cell("dambreak3d.run")["config"]
                                      ["particles"]) == "block"


def test_the_cell_reports_the_dam_breaks_rates_and_the_large_metrics():
    c = harness.cell(CELL)
    assert {m["name"] for m in c["end_to_end"]} == {"particle_steps_per_s",
                                                     "interval_s_p95", "setup_s"}
    per_layer = {m["name"] for m in c["per_layer"]}
    assert per_layer == {f"{n}.large" for n in LARGE} | {B3}
    assert not any("roofline" in n for n in per_layer)
    assert all(m["moves"] == "particle_steps_per_s" for m in c["per_layer"])
    for m in c["end_to_end"] + c["per_layer"]:
        reader(m["name"])


def test_the_large_readers_read_their_bases():
    obs = dict(trace={"steps": 40, "busy_s": 0.7, "device_ops": []},
               graph_nodes_per_step=265.0, rebuilds=3, steps=300,
               memory_peak_bytes=3 * 2**29)
    for name in LARGE:
        assert reader(f"{name}.large")(obs) == reader(name)(obs) is not None


@pytest.mark.parametrize("ops, steps, want", [
    ([["void (anonymous namespace)::cell_sweep_kernel<3, 0, 1, 2, false>(Params)", 0.5],
      ["void (anonymous namespace)::occupied_groups_kernel(int const*, int)", 0.02],
      ["void at::native::elementwise_kernel<128, 2>", 0.3]], 40, 1e3 * 0.52 / 80),
    ([["void (anonymous namespace)::cell_sweep_kernel<3, 0, 1, 2, false>(Params)", 0.25]],
     25, 5.0),
    ([["void (anonymous namespace)::block_sweep_kernel<3, 0, 1, 2, false>(Params)", 0.5]],
     40, None),
    ([], 40, None),
    ([["void (anonymous namespace)::cell_sweep_kernel<3>(Params)", 0.5]], 0, None),
], ids=["both-kernels", "sweep-only", "b1-only", "no-ops", "no-steps"])
def test_b3_ms_per_launch_reads_the_named_device_ops(ops, steps, want):
    read = reader(B3)
    got = read(dict(trace={"steps": steps, "device_ops": ops, "busy_s": 1.0}))
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))
    assert read(dict(trace=None)) is None


def coarse_large(dx=0.05):
    """The cell's configuration at a spacing a test holds, in float64."""
    cfg = harness.cell(CELL)["config"]
    cfg["geometry"]["dx"] = dx
    cfg["constants"].update(dx=dx, m0=1000 * dx**3)
    cfg["kernel"]["h"] = 3**0.5 * dx
    cfg["run"]["dtype"] = "float64"
    return cfg


@pytest.mark.parametrize("route", ["cell", "block"])
def test_coarse_copy_on_either_route_matches_the_reference(monkeypatch, route):
    cfg = coarse_large()
    arrays = harness.deck_arrays(cfg, 2147483711)
    rows = len(arrays[0])
    if route == "cell":
        monkeypatch.setattr(driver, "BLOCK_CAP_LIMIT", rows - 1)
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    assert sim.cfg.sweep_kernel == route and sim.n_live == rows == 1419
    t_out = 0.003
    out = sim.interval_fn(sim.state, t_out)
    steps = int(out.iteration)
    ref, ref_steps = check.reference_interval(cfg, arrays, None, t_out, 4 * steps + 10,
                                              device="cpu")
    assert steps == ref_steps >= 5
    gaps = check.gaps(check.port_numpy(out), ref, steps, ref_steps, sph.physics(cfg))
    assert gaps["steps"] == 0
    for field in ("pos_gap", "vel_gap", "rho_gap"):
        assert gaps[field] <= 1e-9, (field, gaps[field])
