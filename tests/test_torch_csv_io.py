"""The port's CSV loaders (standard ``csv`` module + numpy, no pandas) and
``build_simulation`` against the JAX package's on synthetic DualSPHysics-style
files: quoted, space-padded headers, blanks after the commas, 2D and 3D."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.io import csv_io as jcsv
from sphexample_tpu_torch.io import csv_io as tcsv

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
DX = 0.02


def _write_particles(path, pts3, rho, idp0, style):
    """``style`` 0: plain header; 1: quoted, space-padded header and blanks
    after the commas, extra columns and another column order."""
    with open(path, "w") as fh:
        if style == 0:
            fh.write("Points:0,Points:1,Points:2,Idp,Vel:0,Rhop\n")
            for p, r, i in zip(pts3, rho, idp0):
                fh.write(f"{p[0]:.8f},{p[1]:.8f},{p[2]:.8f},{i},0,{r:.8f}\n")
        else:
            fh.write('"Idp" , "Rhop" , "Type" , "Points:0" , "Points:1" , "Points:2"\n')
            for p, r, i in zip(pts3, rho, idp0):
                fh.write(f"{i}, {r:.8f}, 0, {p[0]:.8f}, {p[1]:.8f}, {p[2]:.8f}\n")


def _write_normals(path, pts3, nrm3, style):
    with open(path, "w") as fh:
        if style == 0:
            fh.write("Normal:0,Normal:1,Normal:2,Points:0,Points:1,Points:2\n")
        else:
            fh.write('"Points:0" , "Points:1" , "Points:2" , "Normal:0" , '
                     '"Normal:1" , "Normal:2"\n')
        for p, n in zip(pts3, nrm3):
            vals = [*n, *p] if style == 0 else [*p, *n]
            fh.write((", " if style else ",").join(f"{v:.8f}" for v in vals) + "\n")


def _deck(tmp_path, style, seed=5):
    """A floor body (with ghost nodes) and a fluid body as CSV files."""
    rng = np.random.default_rng(seed)
    fx, fz = np.meshgrid(np.arange(-3, 11), np.arange(1), indexing="ij")
    floor = np.stack([fx.ravel() * DX, rng.uniform(0, 0.1, fx.size),
                      np.zeros(fx.size)], axis=-1) + 0.0037
    xs, ys, zs = np.meshgrid(np.arange(8), np.arange(2), np.arange(6), indexing="ij")
    fluid = np.stack([xs.ravel() * DX, ys.ravel() * DX, zs.ravel() * DX + DX],
                     axis=-1) + 0.0037
    nb, nf = len(floor), len(fluid)
    normals = np.tile([0.0, 0.0, DX], (nb, 1)) + rng.uniform(-1e-3, 1e-3, (nb, 3))
    files = {k: str(tmp_path / f"{k}_{style}.csv") for k in ("floor", "fluid", "normals")}
    _write_particles(files["floor"], floor, rng.uniform(995, 1005, nb),
                     np.arange(nb), style)
    _write_particles(files["fluid"], fluid, rng.uniform(995, 1005, nf),
                     np.arange(nb, nb + nf), style)
    _write_normals(files["normals"], floor, normals, style)
    return files, nb, nf


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("style", [0, 1])
def test_loaders_match_jax_bit_for_bit(tmp_path, dims, style):
    files, nb, nf = _deck(tmp_path, style)
    for key, n in (("floor", nb), ("fluid", nf)):
        a = tcsv.load_particle_csv(files[key], dims)
        b = jcsv.load_particle_csv(files[key], dims)
        assert a[0].shape == (n, dims)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    a = tcsv.load_boundary_normals(files["normals"], dims)
    b = jcsv.load_boundary_normals(files["normals"], dims)
    assert a[1].shape == (nb, dims) and np.abs(a[2]).max() > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    geoms = lambda M: [M.Geometry(files["floor"], 1, M.ParticleType.FIXED),  # noqa: E731
                       M.Geometry(files["fluid"], 2, M.ParticleType.FLUID)]
    for x, y in zip(tcsv.load_geometries(geoms(T), dims),
                    jcsv.load_geometries(geoms(J), dims)):
        assert x.dtype == y.dtype and len(x) == nb + nf
        np.testing.assert_array_equal(x, y)


def test_loader_errors_name_the_file(tmp_path):
    files, _, _ = _deck(tmp_path, 0)
    with pytest.raises(KeyError, match="Normal:0"):
        tcsv.load_boundary_normals(files["fluid"], 3)
    bad = tmp_path / "bad.csv"
    bad.write_text("Points:0,Points:2,Rhop,Idp\n0.1,0.2,1000,0\n\n0.1,oops,1000,1\n")
    with pytest.raises(ValueError, match="bad.csv:4"):
        tcsv.load_particle_csv(str(bad), 2)


@pytest.mark.parametrize("dims", [2, 3])
def test_build_simulation_matches_jax(tmp_path, dims):
    files, nb, nf = _deck(tmp_path, 1)

    def build(M, **kw):
        const = M.SimulationConstants(dx=DX, c0=40.0, cfl=0.3)
        kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, dims, dx=DX)
        meta = M.SimulationMetaData(simulation_name="csv", save_location=".",
                                    dims=dims, dtype="float64",
                                    mdbc=M.MDBCMode.SIMPLE, grid_margin_cells=4)
        geoms = [M.Geometry(files["floor"], 1, M.ParticleType.FIXED),
                 M.Geometry(files["fluid"], 2, M.ParticleType.FLUID)]
        return M.build_simulation(geoms, meta, const, kern, M.ViscosityModel.ARTIFICIAL,
                                  M.DensityDiffusionModel.LINEAR,
                                  particle_normals_path=files["normals"], **kw)

    st, sj = build(T, device="cpu"), build(J)
    assert st.n_live == sj.n_live == nb + nf
    assert st.cfg.boundary_capacity == sj.cfg.boundary_capacity == nb
    assert st.cfg.grid.cmin == sj.cfg.grid.cmin and st.cfg.grid.shape == sj.cfg.grid.shape
    pt, pj = st.state.particles, sj.state.particles
    for f in ("position", "density", "pressure", "ghost_points", "ghost_normals",
              "id", "ptype", "group_marker", "motion_limiter", "gravity_factor", "active"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                      err_msg=f)
    assert int((pt.ghost_points != 0).any(-1).sum()) == nb
    # and it steps: the floor's densities get corrected
    from sphexample_tpu_torch.core.step import make_fixed_steps_fn

    final = make_fixed_steps_fn(st.cfg, 3)(st.state)
    fixed = final.particles.ptype == int(T.ParticleType.FIXED)
    assert torch.isfinite(final.particles.density).all()
    assert float((final.particles.density[fixed] - 1000.0).abs().max()) > 1e-6
    # without a normals file (or without mDBC) no ghost rows are loaded
    const = T.SimulationConstants(dx=DX)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    geoms = [T.Geometry(files["fluid"], 2, T.ParticleType.FLUID)]
    plain = T.build_simulation(
        geoms, T.SimulationMetaData("csv", ".", dims=dims, dtype="float64"), const, kern,
        T.ViscosityModel.ZERO, T.DensityDiffusionModel.ZERO,
        particle_normals_path=files["normals"], device="cpu")
    assert plain.cfg.boundary_capacity == 1
    assert not plain.state.particles.ghost_points.any()


def test_csv_io_needs_no_pandas(tmp_path):
    files, nb, _ = _deck(tmp_path, 1)
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "from sphexample_tpu_torch.io import csv_io\n"
        f"pts, ghost, nrm = csv_io.load_boundary_normals({files['normals']!r}, 3)\n"
        f"p, rho, idp = csv_io.load_particle_csv({files['floor']!r}, 2)\n"
        "print(len(pts), p.shape[1], int(idp[0]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(nb), "2", "1"]
