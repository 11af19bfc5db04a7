"""The port's deck CLIs (``sphexample_tpu_torch/examples``) against the JAX
package's (``examples/``) on the CPU, in f64: each deck's ``main`` run in
this process with ``--cpu --dtype float64 --max-intervals 1`` on the same
inputs - the procedural 3D dam break at a coarse ``--dx``, the other five
on synthetic CSVs written in each deck's file layout (the reference input
CSVs are not in the repository).  The VTKHDF datasets are held by particle
id within the bands of tests/test_trajectory.py:64-70, the step times within
1e-12, the checkpoint keys against the JAX package's.  Also: ``--resume``
continues the files to the straight run's bytes, ``--shard 4`` against the
single-device CLI and against JAX's ``--shard 4`` on the conftest's virtual
devices (its all-gather path), no card without ``--cpu``, and the run
without ``h5py``."""

import importlib
import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
OFF = 0.0037   # off the map_floor half-integer boundary (test_trajectory.py:35-42)
DX_3D = 0.05   # the coarse procedural 3D dam break
ARGS = ["--cpu", "--dtype", "float64", "--max-intervals", "1"]


# --- synthetic inputs in each deck's file layout ----------------------------------

def _write_particles(path, pts, rho, idp0):
    """A DualSPHysics-style particle CSV (2D points are written in x-z)."""
    pts = np.asarray(pts)
    if pts.shape[1] == 2:
        pts = np.stack([pts[:, 0], np.zeros(len(pts)), pts[:, 1]], axis=-1)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("Points:0,Points:1,Points:2,Idp,Rhop\n")
        for p, r, i in zip(pts, rho, idp0):
            fh.write(f"{p[0]:.10f},{p[1]:.10f},{p[2]:.10f},{i},{r:.10f}\n")


def _write_normals(path, pts, nrm):
    def to3(a):
        a = np.asarray(a)
        return a if a.shape[1] == 3 else np.stack([a[:, 0], np.zeros(len(a)), a[:, 1]], -1)

    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("Normal:0,Normal:1,Normal:2,Points:0,Points:1,Points:2\n")
        for p, n in zip(to3(pts), to3(nrm)):
            fh.write(",".join(f"{v:.10f}" for v in (*n, *p)) + "\n")


def mdbc_tank(dims, dx, tank, block, square=None):
    """The three-layer mDBC tank of chip_smoke.py:mdbc_dam_break at a small
    size: ``tank`` cells inside (open top), three wall layers (floor and
    sides), a fluid block of ``block`` cells in the corner, every boundary
    particle's ghost its reflection about each interface plane it lies
    beyond.  ``square`` (2D): a boundary square of that many cells in the
    fluid, its ghosts reflected out through its nearest face.  Shifted by
    ``OFF``.  Returns (boundary, ghosts, fluid)."""
    axes = [np.arange(-2, n + 2) for n in tank[:-1]] + [np.arange(-2, tank[-1])]
    idx = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dims)
    hi = np.array([n - 2 for n in tank[:-1]] + [np.iinfo(np.int64).max])
    walls = (idx[np.any((idx < 1) | (idx > hi), axis=-1)] + 0.5) * dx
    top = np.array([(n - 1) * dx for n in tank[:-1]] + [np.inf])
    ghost = np.where(walls < dx, 2 * dx - walls, walls)
    ghost = np.where(walls > top, 2 * top - walls, ghost)
    fl = np.stack(np.meshgrid(*[np.arange(1, b + 1) for b in block], indexing="ij"),
                  axis=-1).reshape(-1, dims)
    fluid = (fl + 0.5) * dx
    if square is not None:
        lo = np.array([2, 2]) + 0.0
        sq = np.stack(np.meshgrid(*[np.arange(square)] * 2, indexing="ij"),
                      axis=-1).reshape(-1, 2) + lo
        inside = np.all((fl >= lo) & (fl < lo + square), axis=-1)
        fluid = fluid[~inside]
        sq_pos = (sq + 0.5) * dx
        faces = np.stack([lo * dx, (lo + square) * dx])        # [2, dims]
        dist = np.concatenate([sq_pos - faces[0], faces[1] - sq_pos], axis=-1)
        k = np.argmin(dist, axis=-1)
        axis, side = k % 2, k // 2
        plane = faces[side, axis]
        sq_ghost = sq_pos.copy()
        sq_ghost[np.arange(len(sq)), axis] = 2 * plane - sq_pos[np.arange(len(sq)), axis]
        walls = np.concatenate([walls, sq_pos])
        ghost = np.concatenate([ghost, sq_ghost])
    return walls + OFF, ghost + OFF, fluid + OFF


def _mdbc_files(files, dims, dx, tank, block, square=None, seed=3):
    """Bound, fluid and ghost-node CSVs of :func:`mdbc_tank` at ``files``."""
    walls, ghost, fluid = mdbc_tank(dims, dx, tank, block, square)
    rng = np.random.default_rng(seed)
    nb, nf = len(walls), len(fluid)
    _write_particles(files[0], walls, np.full(nb, 1000.0), np.arange(nb))
    _write_particles(files[1], fluid, 1000.0 + rng.uniform(0, 0.5, nf),
                     np.arange(nb, nb + nf))
    _write_normals(files[2], walls, ghost - walls)


def _square_files(base, dp):
    """The moving square's Fixed, Fluid and Square CSVs: a closed box of one
    wall layer, fluid around a 3 x 3 square of MOVING particles."""
    nx, nz = 16, 10
    idx = np.stack(np.meshgrid(np.arange(-1, nx + 1), np.arange(-1, nz + 1), indexing="ij"),
                   axis=-1).reshape(-1, 2)
    wall = np.any((idx < 0) | (idx >= [nx, nz]), axis=-1)
    inner = idx[~wall]
    sq = np.all((inner >= [3, 3]) & (inner < [6, 6]), axis=-1)
    pos = lambda a: (a + 0.5) * dp + OFF  # noqa: E731
    bodies = (idx[wall], inner[~sq], inner[sq])
    start = 0
    for name, body in zip(("Fixed", "Fluid", "Square"), bodies):
        _write_particles(base / f"MovingSquare_Dp{dp}_{name}.csv", pos(body),
                         np.full(len(body), 1000.0), np.arange(start, start + len(body)))
        start += len(body)


def write_inputs(deck, root: Path):
    """The deck's input CSVs under ``root`` (its ``--input``)."""
    if deck == "moving_square_2d":
        _square_files(root / "moving_square_2d", 0.04)
    elif deck == "still_wedge_mdbc":
        _mdbc_files((root / "still_wedge/StillWedge_Dp0.02_Bound.csv",
                     root / "still_wedge/StillWedge_Dp0.02_Fluid.csv",
                     root / "still_wedge_mdbc/StillWedge_Dp0.02_GhostNodes_Correct.csv"),
                    2, 0.02, (14, 10), (6, 5))
    elif deck == "still_wedge_middle_square_mdbc":
        b = root / "still_wedge_middle_square_mdbc/StillWedge_MiddleSquare_Dp0.02"
        _mdbc_files((Path(f"{b}_Bound.csv"), Path(f"{b}_Fluid.csv"),
                     Path(f"{b}_GhostNodes.csv")), 2, 0.02, (14, 10), (8, 7), square=3)
    elif deck == "dam_break_2d_mdbc":
        b = root / "dam_break_2d/DamBreak2d_Dp0.02_MDBC"
        _mdbc_files((Path(f"{b}_Bound_ThreeLayers.csv"), Path(f"{b}_Fluid_ThreeLayers.csv"),
                     Path(f"{b}_GhostNodes_ThreeLayers.csv")), 2, 0.01, (14, 9), (5, 5))
    elif deck == "duckling_mdbc":
        b = root / "case_duckling_mdbc/CaseDuckling_Dp0.01"
        _mdbc_files((Path(f"{b}_Bound_MDBC.csv"), Path(f"{b}_Fluid_MDBC.csv"),
                     Path(f"{b}_GhostNodes.csv")), 3, 0.01, (5, 3, 5), (2, 2, 3))


# --- running the decks ------------------------------------------------------------

DECKS = {  # deck: (extra arguments, simulation name)
    "dam_break_3d": (["--dx", str(DX_3D)], "DamBreak3D"),
    "moving_square_2d": ([], "MovingSquare2D"),
    "still_wedge_mdbc": ([], "StillWedge"),
    "still_wedge_middle_square_mdbc": ([], "StillWedgeMiddleSquare"),
    "dam_break_2d_mdbc": (["--t-end", "0.01"], "DamBreak2D"),
    "duckling_mdbc": ([], "CaseDuckling"),
}


def port_main(deck, argv):
    return importlib.import_module(f"sphexample_tpu_torch.examples.{deck}").main(argv)


def jax_main(deck, argv, monkeypatch):
    """The JAX deck as its script runs, loaded from ``examples/`` with the
    directory on ``sys.path`` (its ``from _runner import ...``) and
    ``sys.argv`` set; nothing under ``examples/`` is edited."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    monkeypatch.setattr(sys, "argv", [f"{deck}.py", *argv])
    spec = importlib.util.spec_from_file_location(f"jax_example_{deck}",
                                                  ROOT / "examples" / f"{deck}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def _both(deck, tmp_path, monkeypatch, extra=()):
    inp = tmp_path / "input"
    write_inputs(deck, inp)
    args, name = DECKS[deck]
    common = [*ARGS, *args, "--input", str(inp), "--checkpoint-every", "1", *extra]
    port_main(deck, [*common, "--save", str(tmp_path / "port")])
    jax_main(deck, [*common, "--save", str(tmp_path / "jax")], monkeypatch)
    return tmp_path / "port", tmp_path / "jax", name


def read_steps(path):
    """Per step of a transient VTKHDF: its time and every variable (and the
    points) by particle id."""
    from sphexample_tpu_torch.io.vtkhdf import read_transient_polydata

    steps = []
    for t, pts, data in read_transient_polydata(str(path)):
        order = np.argsort(data["ID"], kind="stable")
        steps.append((t, {"Points": pts[order], **{k: v[order] for k, v in data.items()}}))
    return steps


def assert_files_match(a, b):
    """The particle files of two runs by id: integer variables equal; points,
    velocity and density in the bands of tests/test_trajectory.py:64-70, the
    other float variables (pressure, acceleration, kernel sums) within that
    file's velocity band of 1e-7 relative (and 1e-9 of their largest
    value)."""
    sa, sb = read_steps(a), read_steps(b)
    assert len(sa) == len(sb) > 1
    for (ta, da), (tb, db) in zip(sa, sb):
        assert sorted(da) == sorted(db)
        assert ta == pytest.approx(tb, rel=1e-12, abs=0)
        for k in da:
            x, y = da[k], db[k]
            if not np.issubdtype(x.dtype, np.floating):
                np.testing.assert_array_equal(x, y, err_msg=k)
            elif k == "Points":
                scale = float(np.abs(y).max())
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-9 * scale, err_msg=k)
            elif k == "Velocity":
                np.testing.assert_allclose(x, y, rtol=1e-7, atol=1e-8, err_msg=k)
            elif k == "Density":
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-6, err_msg=k)
            else:
                scale = float(np.abs(y).max()) or 1.0
                np.testing.assert_allclose(x, y, rtol=1e-7, atol=1e-9 * scale, err_msg=k)


def assert_same_bytes(a, b):
    """Every dataset and attribute of two HDF5 files equal."""
    import h5py

    def read(path):
        out = {}
        with h5py.File(path, "r", locking=False) as f:
            def visit(name, obj):
                for k, v in obj.attrs.items():
                    out[f"{name}@{k}"] = np.asarray(v)
                if isinstance(obj, h5py.Dataset):
                    out[name] = np.asarray(obj[...])
            f.visititems(visit)
        return out

    da, db = read(a), read(b)
    assert sorted(da) == sorted(db) and da
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# what only the JAX package's checkpoints hold: its Pallas tables and their
# telemetry, and its candidate windows (the port's kernels have none)
JAX_ONLY = ("f::.pallas_tables", "f::.block_tables", "f::.max_chunks")
JAX_WINDOWS = {"mpc", "cseg", "maxc", "ct_cap"}
PORT_ONLY = {"rebuilds", "grid_cmin", "grid_shape"}


def assert_checkpoints_match(a, b):
    with np.load(a) as pa, np.load(b) as pj:
        kp, kj = set(pa.files), set(pj.files)
        assert kp - kj == PORT_ONLY
        assert all(k.startswith(JAX_ONLY) or k in JAX_WINDOWS for k in kj - kp)
        assert int(pa["counter"]) == int(pj["counter"]) == 2
        for k in ("f::.total_time", "f::.current_dt"):
            assert float(pa[k]) == pytest.approx(float(pj[k]), rel=1e-12)
        assert int(pa["f::.iteration"]) == int(pj["f::.iteration"])


@pytest.mark.parametrize("deck", list(DECKS))
def test_deck_matches_the_jax_deck(deck, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    port, jax, name = _both(deck, tmp_path, monkeypatch)
    assert_files_match(port / f"{name}.vtkhdf", jax / f"{name}.vtkhdf")
    assert_checkpoints_match(port / "checkpoint.npz", jax / "checkpoint.npz")
    for d in (port, jax):
        assert (d / f"{name}_SingleVTKHDFStateFile.py").is_file()
        assert (d / "SimulationLog.log").is_file()
    grids = [port / f"{name}_GridCells.vtkhdf", jax / f"{name}_GridCells.vtkhdf"]
    assert grids[0].exists() == grids[1].exists()


def test_resume_continues_the_files_to_the_straight_run(tmp_path):
    """One interval, a checkpoint, then ``--resume`` for one more: the
    particle file, the grid-cells file and the last checkpoint are the bytes
    of the straight two-interval run."""
    pytest.importorskip("h5py")
    deck, (args, name) = "dam_break_3d", DECKS["dam_break_3d"]
    base = ["--cpu", "--dtype", "float64", *args, "--checkpoint-every", "1"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    port_main(deck, [*base, "--max-intervals", "2", "--save", str(straight)])
    port_main(deck, [*base, "--max-intervals", "1", "--save", str(resumed)])
    first = resumed / "checkpoint.npz"
    shutil.copy(first, tmp_path / "ckpt2.npz")
    sim = port_main(deck, [*base, "--max-intervals", "1", "--save", str(resumed),
                           "--resume", str(tmp_path / "ckpt2.npz")])
    assert float(sim.state.total_time) > 0.02
    for f in (f"{name}.vtkhdf", f"{name}_GridCells.vtkhdf"):
        assert_same_bytes(resumed / f, straight / f)
    with np.load(resumed / "checkpoint.npz") as a, np.load(straight / "checkpoint.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    log = (resumed / "SimulationLog.log").read_text()
    assert "resuming from" in log and "output counter 2" in log


def test_shard_matches_the_single_device_cli_and_jax(tmp_path, monkeypatch):
    """``--shard 4 --cpu``: four thread ranks on the CPU against the port's
    single-device CLI run and against the JAX deck's ``--shard 4 --cpu`` (its
    all-gather path on the conftest's virtual devices): the trajectory
    bands (tests/test_torch_sharded_step.py:test_sharded_matches_jax_all_gather)."""
    pytest.importorskip("h5py")
    deck, name = "dam_break_3d", DECKS["dam_break_3d"][1]
    common = [*ARGS, "--dx", "0.04"]   # slabs thick enough for the 1-hop halo
    sim = port_main(deck, [*common, "--shard", "4", "--save", str(tmp_path / "shard")])
    assert isinstance(sim.state, tuple) and len(sim.state) == 4 and sim.cfg.halo > 0
    assert sim.mesh.size == 4 and sim.mesh.devices[0].type == "cpu"
    port_main(deck, [*common, "--save", str(tmp_path / "single")])
    jax_main(deck, [*common, "--shard", "4", "--save", str(tmp_path / "jax")], monkeypatch)
    shard = tmp_path / "shard" / f"{name}.vtkhdf"
    assert_files_match(shard, tmp_path / "single" / f"{name}.vtkhdf")
    assert_files_match(shard, tmp_path / "jax" / f"{name}.vtkhdf")


def test_without_a_card_the_cli_raises_before_any_work(tmp_path, monkeypatch):
    from sphexample_tpu_torch.core import driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stepped = []
    monkeypatch.setattr(driver, "run_simulation", lambda *a, **k: stepped.append(a))
    save = tmp_path / "out"
    for deck, (args, _) in DECKS.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_main(deck, [*args, "--max-intervals", "1", "--save", str(save)])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main("dam_break_3d", ["--shard", "4", "--save", str(save)])
    assert not stepped and not save.exists()


def test_without_h5py_the_run_says_so_and_keeps_its_checkpoints(tmp_path, monkeypatch,
                                                                capsys):
    """No VTKHDF where ``h5py`` does not import (the card machine): the run
    says so on stderr and in the log before its first step, names h5py, and
    still writes its checkpoints and the ParaView state file."""
    from sphexample_tpu_torch.core import driver
    from sphexample_tpu_torch.examples import _runner

    for mod in ("sphexample_tpu_torch.io.output", "sphexample_tpu_torch.io.vtkhdf"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setitem(sys.modules, "h5py", None)
    order = []
    real = driver.run_simulation

    def run(*a, **k):
        order.append(("run", _runner.NO_H5PY in capsys.readouterr().err))
        return real(*a, **k)

    monkeypatch.setattr(driver, "run_simulation", run)
    save = tmp_path / "out"
    deck, (args, name) = "dam_break_3d", DECKS["dam_break_3d"]
    port_main(deck, [*ARGS, *args, "--checkpoint-every", "1", "--save", str(save)])
    assert order == [("run", True)]
    assert "h5py" in _runner.NO_H5PY
    assert _runner.NO_H5PY in (save / "SimulationLog.log").read_text()
    assert not list(save.glob("*.vtkhdf"))
    assert (save / f"{name}_SingleVTKHDFStateFile.py").is_file()
    with np.load(save / "checkpoint.npz") as ck:
        assert int(ck["counter"]) == 2


def test_profile_traces_the_second_interval(tmp_path):
    deck = "moving_square_2d"
    write_inputs(deck, tmp_path / "input")
    prof = tmp_path / "prof"
    common = ["--cpu", "--dtype", "float64", "--input", str(tmp_path / "input"),
              "--profile", str(prof)]
    port_main(deck, [*common, "--max-intervals", "1", "--save", str(tmp_path / "one")])
    assert not prof.exists()   # one interval: nothing traced
    port_main(deck, [*common, "--max-intervals", "2", "--save", str(tmp_path / "two")])
    trace = (prof / "trace.json").read_text()
    assert '"traceEvents"' in trace and "aten::" in trace


def test_argparser_keeps_the_jax_flags_but_pallas(monkeypatch):
    from sphexample_tpu_torch.examples._runner import standard_argparser as port_ap

    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    spec = importlib.util.spec_from_file_location("jax_runner", ROOT / "examples/_runner.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_ap = mod.standard_argparser("out/x")
    pa = {a.dest: a.default for a in port_ap("out/x")._actions}
    ja = {a.dest: a.default for a in jax_ap._actions}
    assert set(ja) - set(pa) == {"pallas"} and set(pa) == set(ja) - {"pallas"}
    assert pa == {k: v for k, v in ja.items() if k != "pallas"}
    with pytest.raises(SystemExit):
        port_ap("out/x").parse_args(["--pallas"])
