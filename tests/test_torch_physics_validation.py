"""The port's counterparts of ``tests/test_physics_validation.py`` on the CPU
path: the dam-break front speed (held against the JAX package on the same
case), hydrostatic settling, the still-wedge profile (reference CSVs) and a
procedural still-water tank with three mDBC wall layers, run through both
packages from the CSV files this test writes."""

import os

import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.io.casegen import dam_break_2d as j_dam_break_2d
from sphexample_tpu_torch.io.casegen import dam_break_2d

torch.set_num_threads(1)
OFF = 0.0037   # tests/test_trajectory.py:35-42: lattices off the cell boundary


def _front_speed(M, dam_break, **kw):
    """tests/test_physics_validation.py:21-71's case; (ratio, fluid x, fluid
    z, fluid density) at t = 0.15 s."""
    dx = 0.02
    const = M.SimulationConstants(dx=dx, c0=34.0, cfl=0.3, alpha=0.02)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=dx)
    meta = M.SimulationMetaData(
        simulation_name="front", save_location="out/front", dims=2,
        simulation_time=0.15, output_times=0.05, dtype="float32", block_size=256)
    pos, dens, ptype, grp, idp = dam_break(dx)
    sim = M.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                M.ViscosityModel.ARTIFICIAL,
                                M.DensityDiffusionModel.LINEAR, **kw)
    fluid0 = pos[ptype == 1]
    sim = M.run_simulation(sim)
    p = sim.state.particles
    host = lambda a: np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)  # noqa: E731
    is_fluid = host(p.ptype) == 1
    x = host(p.position)[is_fluid, 0]
    z = host(p.position)[is_fluid, 1]
    advance = np.quantile(x, 0.99) - fluid0[:, 0].max()
    ratio = advance / (np.sqrt(9.81 * fluid0[:, 1].max()) * float(sim.state.total_time))
    return ratio, x, z, host(p.density)[is_fluid]


def test_dam_break_front_speed():
    """The JAX test's gates on the port, and the JAX package's ratio on the
    same case equal to 1e-6 (it has been bit for bit)."""
    ratio, x, z, rho = _front_speed(T, dam_break_2d, device="cpu")
    print(f"front speed ratio {ratio:.4f} (pinned 0.61)")
    assert 0.51 < ratio < 0.71
    assert x.max() < 1.65 and z.min() > -0.05
    assert rho.min() > 850 and rho.max() < 1150
    ratio_j, *_ = _front_speed(J, j_dam_break_2d)
    assert abs(ratio - ratio_j) <= 1e-6, (ratio, ratio_j)


def test_hydrostatic_settling():
    """tests/test_physics_validation.py:74-106 on the port: the deep
    pressure within 15 % of rho g h at t = 0.4 s."""
    dx = 0.02
    const = T.SimulationConstants(dx=dx, c0=40.0, cfl=0.4)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dx)
    pos, dens, ptype, grp, idp = dam_break_2d(dx)
    meta = T.SimulationMetaData(
        simulation_name="hydro", save_location="out/hydro", dims=2,
        simulation_time=0.4, output_times=0.1, dtype="float32", block_size=256)
    sim = T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                T.ViscosityModel.ARTIFICIAL,
                                T.DensityDiffusionModel.LINEAR, device="cpu")
    sim = T.run_simulation(sim)
    p = sim.state.particles
    is_fluid = p.ptype.numpy() == 1
    z = p.position.numpy()[is_fluid, 1]
    pres = p.pressure.numpy()[is_fluid]
    deep = z < np.quantile(z, 0.1)
    p_deep = np.median(pres[deep])
    expected = 1000 * 9.81 * (np.quantile(z, 0.95) - np.median(z[deep]))
    print(f"deep pressure ratio {p_deep / expected:.4f} (expect ~1)")
    assert 0.85 * expected < p_deep < 1.15 * expected


def _hydrostatic_profile(p, to_np):
    """The JAX wedge test's reading: relative error of the fluid pressure
    against rho0 g (z_surf - z) below the noisy surface, and the density."""
    fluid = to_np(p.ptype) == 1
    z = to_np(p.position)[fluid, -1]
    pres = to_np(p.pressure)[fluid]
    dens = to_np(p.density)[fluid]
    ph = 1000.0 * 9.81 * (z.max() - z)
    deep = ph > 0.05 * ph.max()
    err = np.abs(pres[deep] - ph[deep]) / ph.max()
    return err, dens, pres


def test_still_wedge_pressure_profile(tmp_path):
    """tests/test_physics_validation.py:108-157 on the port: the reference
    StillWedgeMDBC CSVs run to t = 0.1 s, within its bands."""
    from sphexample_tpu_torch.examples._runner import standard_argparser

    base = standard_argparser("out").parse_args([]).input   # the decks' default
    bound = f"{base}/still_wedge/StillWedge_Dp0.02_Bound.csv"
    if not os.path.exists(bound):
        pytest.skip("reference input CSVs unavailable")
    const = T.SimulationConstants(dx=0.02, c0=42.48576250492629, delta_sph=0.1, cfl=0.5)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    geoms = [
        T.Geometry(csv_file=bound, group_marker=1, type=T.ParticleType.FIXED),
        T.Geometry(csv_file=f"{base}/still_wedge/StillWedge_Dp0.02_Fluid.csv",
                   group_marker=2, type=T.ParticleType.FLUID),
    ]
    meta = T.SimulationMetaData(
        simulation_name="WedgeProfile", save_location=str(tmp_path), dims=2,
        simulation_time=0.1, output_times=0.05, dtype="float32",
        mdbc=T.MDBCMode.SIMPLE, block_size=256)
    sim = T.build_simulation(
        geoms, meta, const, kern, T.ViscosityModel.ARTIFICIAL,
        T.DensityDiffusionModel.LINEAR,
        particle_normals_path=(
            f"{base}/still_wedge_mdbc/StillWedge_Dp0.02_GhostNodes_Correct.csv"),
        device="cpu")
    sim = T.run_simulation(sim)
    err, dens, pres = _hydrostatic_profile(sim.state.particles, lambda a: a.numpy())
    assert np.isfinite(dens).all() and np.isfinite(pres).all()
    assert dens.min() > 1000 * 0.98 and dens.max() < 1000 * 1.05
    assert err.mean() < 0.03 and err.max() < 0.05, (err.mean(), err.max())


# the still-water tank: NX x NF fluid sites at DX, three wall layers on the
# floor and both sides, walls WALL_TOP sites high; the still wedge's constants
DX, NX, NF, LAYERS, WALL_TOP = 0.02, 30, 15, 3, 20
C0 = 42.48576250492629


def _write_tank(root):
    """The tank as DualSPHysics-style CSVs (x-z in Points:0 / Points:2): the
    walls, the fluid and the walls' ghost nodes (normal = reflection about
    the wall's interface planes x = 0, x = NX DX, z = 0, less the point).
    Densities from the inverse equation of state at rho0 g (z_top - z), the
    profile the check reads."""
    ix, iz = np.meshgrid(np.arange(-LAYERS, NX + LAYERS), np.arange(-LAYERS, WALL_TOP),
                         indexing="ij")
    ix, iz = ix.ravel(), iz.ravel()
    wall = (ix < 0) | (ix >= NX) | (iz < 0)
    fluid = ~wall & (iz < NF)
    pts = (np.stack([ix, iz], axis=-1) + 0.5) * DX
    top = (NF - 0.5) * DX
    gamma = 7.0
    B = C0**2 * 1000.0 / gamma
    rho = 1000.0 * (1 + 1000.0 * 9.81 * (top - pts[:, 1]) / B) ** (1 / gamma)
    hi = NX * DX
    ghost = np.where(pts < 0, -pts, pts)
    ghost[:, 0] = np.where(pts[:, 0] > hi, 2 * hi - pts[:, 0], ghost[:, 0])
    cols = "Points:0,Points:1,Points:2,Idp,Rhop"

    def xz(a):
        return np.stack([a[:, 0], np.zeros(len(a)), a[:, 1]], axis=-1) + OFF * np.array(
            [1.0, 0.0, 1.0])

    def write(path, header, rows):
        with open(path, "w") as fh:
            fh.write(header + "\n")
            fh.writelines(",".join(repr(v) for v in row) + "\n" for row in rows.tolist())

    nb = int(wall.sum())
    ids = np.arange(len(pts))
    order = np.concatenate([ids[wall], ids[fluid]])
    table = np.concatenate([xz(pts[order]), np.arange(len(order))[:, None],
                            rho[order][:, None]], axis=1)
    files = {k: str(root / f"Tank_{k}.csv") for k in ("Bound", "Fluid", "GhostNodes")}
    write(files["Bound"], cols, table[:nb])
    write(files["Fluid"], cols, table[nb:])
    normals = ghost[wall] - pts[wall]
    write(files["GhostNodes"], "Normal:0,Normal:1,Normal:2,Points:0,Points:1,Points:2",
          np.concatenate([xz(normals) - OFF * np.array([1.0, 0.0, 1.0]), xz(pts[wall])],
                         axis=1))
    return files, nb, int(fluid.sum())


def _tank(M, files, save, **kw):
    const = M.SimulationConstants(dx=DX, c0=C0, delta_sph=0.1, cfl=0.5)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=DX)
    geoms = [M.Geometry(files["Bound"], 1, M.ParticleType.FIXED),
             M.Geometry(files["Fluid"], 2, M.ParticleType.FLUID)]
    meta = M.SimulationMetaData(
        simulation_name="StillTank", save_location=str(save), dims=2,
        simulation_time=0.1, output_times=0.05, dtype="float64",
        mdbc=M.MDBCMode.SIMPLE, block_size=256)
    sim = M.build_simulation(geoms, meta, const, kern, M.ViscosityModel.ARTIFICIAL,
                             M.DensityDiffusionModel.LINEAR,
                             particle_normals_path=files["GhostNodes"], **kw)
    return M.run_simulation(sim)


def _by_id(p, to_np):
    ids = to_np(p.id)
    order = np.argsort(ids)
    order = order[ids[order] > 0]
    return {k: to_np(getattr(p, f))[order] for k, f in
            (("pos", "position"), ("vel", "velocity"), ("dens", "density"))}


def test_still_tank_mdbc_profile(tmp_path):
    """A still-water 2D tank with three mDBC wall layers, written as CSVs and
    run to t = 0.1 s (f64) through both packages: the port within the JAX
    wedge test's bands (mean error < 3 %, max < 5 %, density within [980,
    1050]) and its end state within the trajectory bands of
    tests/test_trajectory.py:64-70 of the JAX run."""
    files, nb, nf = _write_tank(tmp_path)
    st = _tank(T, files, tmp_path / "t", device="cpu")
    assert st.n_live == nb + nf and st.cfg.boundary_capacity == nb
    pt = st.state.particles
    to_t = lambda a: a.numpy()  # noqa: E731
    err, dens, pres = _hydrostatic_profile(pt, to_t)
    print(f"still tank: err mean {err.mean():.4f} max {err.max():.4f}, "
          f"rho [{dens.min():.2f}, {dens.max():.2f}]")
    assert np.isfinite(dens).all() and np.isfinite(pres).all()
    assert dens.min() > 980 and dens.max() < 1050
    assert err.mean() < 0.03 and err.max() < 0.05, (err.mean(), err.max())

    sj = _tank(J, files, tmp_path / "j")
    fw, ref = _by_id(pt, to_t), _by_id(sj.state.particles, np.asarray)
    assert float(st.state.total_time) == pytest.approx(float(sj.state.total_time), rel=1e-12)
    assert float(st.state.current_dt) == pytest.approx(float(sj.state.current_dt), rel=1e-12)
    scale = float(np.abs(ref["pos"]).max())
    np.testing.assert_allclose(fw["pos"], ref["pos"], rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(fw["vel"], ref["vel"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(fw["dens"], ref["dens"], rtol=1e-9, atol=1e-6)


def test_analyze_dambreak_reads_the_port_output(tmp_path, monkeypatch):
    """``tools/analyze_dambreak.py``, unchanged, on the VTKHDF the port's
    ``dam_break_3d`` CLI writes (coarse dx, 3 intervals, on the CPU): it
    exits 0 with "OK", and its front and density bounds are the port's own
    readings (``utils/validation.py:dam_break_readings``) of the states
    saved."""
    pytest.importorskip("h5py")
    import subprocess
    import sys
    from pathlib import Path

    from sphexample_tpu_torch.core import driver
    from sphexample_tpu_torch.examples import dam_break_3d
    from sphexample_tpu_torch.utils.validation import dam_break_readings

    readings = []
    real = driver.run_simulation

    def run_simulation(sim, save_callback=None, **kw):
        def save(counter, state):
            readings.append(dam_break_readings(state))
            save_callback(counter, state)

        return real(sim, save_callback=save, **kw)

    monkeypatch.setattr(driver, "run_simulation", run_simulation)
    save = tmp_path / "db3"
    dam_break_3d.main(["--cpu", "--dx", "0.05", "--max-intervals", "3", "--save", str(save)])
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "tools/analyze_dambreak.py",
                        str(save / "DamBreak3D.vtkhdf")], cwd=root,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stderr.strip().splitlines()[-1] == "OK"
    rows = [line.split() for line in r.stdout.strip().splitlines()[1:]]
    assert len(rows) == len(readings) == 4
    for row, rd in zip(rows, readings):
        assert row[2] == f"{rd['x_front']:.4f}" and row[3] == f"{rd['X']:.3f}"
        assert row[4] == f"{rd['rho_min']:.2f}" and row[5] == f"{rd['rho_max']:.2f}"
        assert row[0] == f"{rd['t']:.4f}" and row[7] == "0" and rd["nan"] == 0
    assert float(rows[-1][2]) > float(rows[0][2])    # the front moved


def test_dam_break_3d_readings_match_jax():
    """``compare_dam_break.py`` at a coarse dx: the 3D dam break deck through
    both packages on the CPU in f64, tools/analyze_dambreak.py's readings at
    every output within the trajectory bands of tests/test_trajectory.py:64-70
    (positions and densities 1e-9 relative, speeds 1e-7)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "compare_dam_break.py"
    spec = importlib.util.spec_from_file_location("compare_dam_break", path)
    cmp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cmp)
    jr, tr = (cmp.run(package, 0.08, 0.06, "float64") for package in ("jax", "torch"))
    assert jr["steps"] == tr["steps"] and jr["n"] == tr["n"]
    assert len(jr["readings"]) == len(tr["readings"]) == 7
    for a, b in zip(jr["readings"], tr["readings"]):
        for key, rel in (("t", 1e-12), ("x_front", 1e-9), ("rho_min", 1e-9),
                         ("rho_max", 1e-9), ("vmax", 1e-7)):
            assert a[key] == pytest.approx(b[key], rel=rel), (key, a, b)
        assert a["outside_band"] == b["outside_band"]
    assert tr["readings"][-1]["vmax"] > 0.3    # the column is collapsing
