"""``procedural_decks.py`` (the still tank of the ``duckling_mdbc`` deck and
the moving-square box of ``moving_square_2d``, written in the decks' CSV
layouts) on the CPU: each writer's files through the port's deck CLI give
the state that direct assembly from the arrays gives, by particle id; the
ghost nodes and the boundary count; the full sizes; and ``compare_case.py``
at a very short end time, both packages within the trajectory bands of
tests/test_trajectory.py:64-70 (f64)."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import compare_case  # noqa: E402
import procedural_decks as pd  # noqa: E402

torch.set_num_threads(1)
SMALL_TANK = dict(nx=5, ny=3, depth=4, height=6)


def _through_cli(deck, argv, monkeypatch):
    """The simulation the port's deck CLI builds from its files (``--cpu``),
    captured where it would start to run."""
    from sphexample_tpu_torch.core import driver

    built = []

    def run_simulation(sim, **kw):
        built.append(sim)
        return sim

    monkeypatch.setattr(driver, "run_simulation", run_simulation)
    importlib.import_module(f"sphexample_tpu_torch.examples.{deck}").main(["--cpu", *argv])
    return built[0]


def _by_id(sim):
    p = sim.state.particles
    order = torch.argsort(p.id)
    order = order[p.id[order] > 0]
    fields = ("position", "density", "ptype", "group_marker", "ghost_points", "ghost_normals")
    return {f: getattr(p, f)[order] for f in fields if getattr(p, f, None) is not None}


def _assert_same(a, b):
    da, db = _by_id(a), _by_id(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert torch.equal(da[k], db[k]), k
    assert a.n_live == b.n_live and a.cfg.boundary_capacity == b.cfg.boundary_capacity


def test_still_tank_files_through_the_cli_are_the_arrays(tmp_path, monkeypatch):
    """duckling_mdbc on the written tank = assemble_simulation on the arrays,
    with the deck's constants; the boundary capacity is the wall count."""
    case = pd.write_still_tank(str(tmp_path / "input"), SMALL_TANK)
    sim = _through_cli("duckling_mdbc", ["--input", str(tmp_path / "input"),
                                         "--save", str(tmp_path / "out")], monkeypatch)
    arrays, ghosts, normals = pd.still_tank_arrays(case)
    const = T.SimulationConstants(dx=pd.TANK_DX, c0=pd.TANK_C0, delta_sph=0.1, cfl=0.2,
                                  alpha=0.02, m0=0.001)
    ref = T.assemble_simulation(
        *arrays, sim.meta, const, T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, dx=0.01, k=1.5),
        T.ViscosityModel.ARTIFICIAL, T.DensityDiffusionModel.LINEAR,
        ghost_points=ghosts, ghost_normals=normals, device="cpu")
    _assert_same(sim, ref)
    assert sim.cfg.boundary_capacity == len(case["boundary"])


def test_moving_square_files_through_the_cli_are_the_arrays(tmp_path, monkeypatch):
    """moving_square_2d --dp 0.1 on the written box = assemble_simulation on
    the arrays with the deck's geometry (the square MOVING, marker 3)."""
    dp = pd.SQUARE_DP["coarse"]
    case = pd.write_moving_square(str(tmp_path / "input"), dp)
    sim = _through_cli("moving_square_2d", ["--dp", str(dp), "--input", str(tmp_path / "input"),
                                            "--save", str(tmp_path / "out")], monkeypatch)
    const = T.SimulationConstants(dx=dp, c0=28.0, delta_sph=0.1, g=0.0, Cb=112000.0,
                                  alpha=1e-6, cfl=0.2)
    ref = T.assemble_simulation(
        *pd.moving_square_arrays(case), sim.meta, const,
        T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dp, k=float(np.sqrt(2))),
        T.ViscosityModel.LAMINAR_SPS, T.DensityDiffusionModel.LINEAR,
        geometries=[
            T.Geometry("", 1, T.ParticleType.FIXED), T.Geometry("", 2, T.ParticleType.FLUID),
            T.Geometry("", 3, T.ParticleType.MOVING,
                       T.MotionDetails(velocity=pd.SQUARE_SPEED, start_time=0.0, duration=3.0,
                                       direction=(1.0, 0.0)))],
        device="cpu")
    _assert_same(sim, ref)
    p = sim.state.particles
    moving = p.ptype == int(T.ParticleType.MOVING)
    assert int(moving.sum()) == len(case["square"]) == 100
    assert bool((p.group_marker[moving] == 3).all())


def test_ghost_nodes_and_boundary_count(tmp_path):
    """Every wall row has one ghost node, its reflection about each interface
    plane it lies beyond: inside the tank, mirrored to the same distance from
    the plane, the normal pointing into the fluid; the CLI's boundary
    capacity is the count of those rows."""
    case = pd.still_tank(**SMALL_TANK)
    walls, ghosts = case["boundary"] - pd.OFF, case["ghosts"] - pd.OFF
    hi = np.array([SMALL_TANK["nx"], SMALL_TANK["ny"]]) * pd.TANK_DX
    assert len(ghosts) == len(walls)
    assert np.all(ghosts[:, :2] > 0) and np.all(ghosts[:, :2] < hi) and np.all(ghosts[:, 2] > 0)
    for axis, plane in ((0, 0.0), (0, hi[0]), (1, 0.0), (1, hi[1]), (2, 0.0)):
        beyond = walls[:, axis] < plane if plane == 0.0 else walls[:, axis] > plane
        np.testing.assert_allclose(ghosts[beyond, axis] - plane, plane - walls[beyond, axis],
                                   atol=1e-15)
    inside = np.all((walls[:, :2] > 0) & (walls[:, :2] < hi), axis=-1) & (walls[:, 2] > 0)
    assert not inside.any()
    normals = ghosts - walls
    assert np.all(np.linalg.norm(normals, axis=-1) > 0)
    nx, ny, h = SMALL_TANK["nx"], SMALL_TANK["ny"], SMALL_TANK["height"]
    assert len(walls) == (nx + 6) * (ny + 6) * (h + 3) - nx * ny * h


def test_full_sizes():
    """The full cases of chip_smoke.py's phase 20 and the coarse ones of
    compare_case.py: the counts the decks are sized by."""
    tank = pd.still_tank(**pd.TANK_SIZES["full"])
    assert (len(tank["fluid"]), len(tank["boundary"])) == (150000, 55248)
    coarse = pd.still_tank(**pd.TANK_SIZES["coarse"])
    assert (len(coarse["fluid"]), len(coarse["boundary"])) == (750, 4203)
    sq = pd.moving_square(pd.SQUARE_DP["full"])
    assert [len(sq[k]) for k in ("fixed", "fluid", "square")] == [4536, 122500, 2500]
    body = sq["square"] - pd.OFF
    np.testing.assert_allclose(body.mean(axis=0), pd.SQUARE_CENTRE, atol=1e-9)
    np.testing.assert_allclose(np.ptp(body, axis=0), pd.SQUARE_SIDE - pd.SQUARE_DP["full"],
                               atol=1e-9)
    z = tank["fluid"][:, 2]
    rho = tank["rho_f"]
    assert rho[np.argmin(z)] > rho[np.argmax(z)] and abs(rho[np.argmax(z)] - 1000.0) < 1e-9


@pytest.mark.parametrize("case,t_end,size", [("still_tank", 0.0015, SMALL_TANK),
                                             ("moving_square", 0.01, None)])
def test_compare_case_at_a_short_end_time(tmp_path, case, t_end, size):
    """compare_case.run through both packages' CLIs (f64; the still tank on a
    small floor): the same steps, outputs and rows, and every reading within
    the trajectory bands of tests/test_trajectory.py:64-70 (density 1e-9
    relative, speeds 1e-7, times 1e-12; the body's position as positions,
    1e-9)."""
    pytest.importorskip("h5py")
    jr = compare_case.run("jax", case, t_end, "float64", tmp_path / "jax", size)
    tr = compare_case.run("torch", case, t_end, "float64", tmp_path / "torch", size)
    assert (jr["steps"], jr["n"], len(jr["readings"])) == (tr["steps"], tr["n"],
                                                          len(tr["readings"]))
    assert jr["steps"] > 5 and len(jr["readings"]) >= 2
    for a, b in zip(jr["readings"], tr["readings"]):
        for key, rel in (("t", 1e-12), ("rho_min", 1e-9), ("rho_max", 1e-9), ("vmax", 1e-7),
                         ("x_body", 1e-9)):
            if key in a:
                assert b[key] == pytest.approx(a[key], rel=rel, abs=1e-12), (key, a, b)
        if "body_err" in a:
            assert abs(a["body_err"] - b["body_err"]) <= 1e-9 * abs(a["x_body"])
        assert (a["nan"], a["out_band"], a["flags"]) == (b["nan"], b["out_band"], b["flags"])
    assert tr["readings"][-1]["vmax"] > 0
