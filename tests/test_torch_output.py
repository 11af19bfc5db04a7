"""VTKHDF output of the port against the JAX package's writers: from one
state (``state_from_numpy`` of a JAX state) both ``OutputManager``s write
files equal dataset by dataset and attribute by attribute, in single-file,
multi-file and grid-cells modes; resume truncates and appends; the
crash-recovery helpers; a 4-slab save equals the single-device save; and the
VTKHDF of a ``run_simulation`` with the asynchronous saver equals the
synchronous one.  ``h5py`` is needed (it imports here; the card may lack it)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.core.step import make_fixed_steps_fn as j_fixed
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.ops.cell_list import Grid
from sphexample_tpu_torch.state import split_state
from test_torch_driver import tiny

torch.set_num_threads(1)
VARS = ("ChunkID", "Kernel", "KernelGradient", "Density", "Pressure", "Velocity",
        "Acceleration", "BoundaryBool", "ID", "Type", "GroupMarker", "GhostPoints",
        "GhostNormals")


@pytest.fixture
def h5():
    return pytest.importorskip("h5py")


def _meta(M, save_location, **kw):
    return M.SimulationMetaData(
        simulation_name="Tiny", save_location=str(save_location), dims=2,
        dtype="float64", simulation_time=0.01, output_times=0.002,
        grid_margin_cells=4, block_size=32, output_variables=VARS, **kw)


def _tiny(M, save_location, **kw):
    return tiny(M, save_location, output_variables=VARS, block_size=32, **kw)


def _leaves(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "particles":
            out.update({f"particles.{g.name}": np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
    return out


def _jax_states(tmp, n=3):
    """``n`` cell-sorted JAX states 4 steps apart, with STORE-mode fields
    and ghost columns filled with numbers so that every variable is live."""
    sim = _tiny(J, tmp)
    state, out = sim.state, []
    for _ in range(n):
        state = j_fixed(sim.cfg, 4)(state)
        p = state.particles
        k = np.arange(p.capacity, dtype=np.float64)
        state = state.replace(particles=p.replace(
            kernel_w=p.kernel_w + k, kernel_grad=p.kernel_grad + k[:, None] * 0.5,
            ghost_points=p.ghost_points - k[:, None], ghost_normals=p.ghost_normals + 2.0))
        out.append(state)
    return sim, out


def _datasets(h5, path):
    """Every dataset and attribute of an HDF5 file, by path."""
    out = {}
    with h5.File(path, "r", locking=False) as f:
        def visit(name, obj):
            for a, v in obj.attrs.items():
                out[f"{name}@{a}"] = np.asarray(v)
            if isinstance(obj, h5.Dataset):
                out[name] = (np.asarray(obj[...]), obj.dtype)
        f.visititems(visit)
        for a, v in f["VTKHDF"].attrs.items():
            out[f"VTKHDF@{a}"] = np.asarray(v)
    return out


def _assert_same_files(h5, a, b):
    da, db = _datasets(h5, a), _datasets(h5, b)
    assert sorted(da) == sorted(db)
    for k in da:
        if isinstance(da[k], tuple):
            assert da[k][1] == db[k][1], k
            np.testing.assert_array_equal(da[k][0], db[k][0], err_msg=k)
        else:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def _write_both(h5, tmp, **meta_kw):
    """The same three states through both packages' OutputManager."""
    from sphexample_tpu.io.output import OutputManager as JOut
    from sphexample_tpu_torch.io.output import OutputManager as TOut

    sim_j, states = _jax_states(tmp / "src")
    kern = sim_j.cfg.spec.kernel
    outs = {}
    for name, M, Out, conv in (("jax", J, JOut, lambda s: s),
                               ("port", T, TOut, lambda s: T.state_from_numpy(_leaves(s), "cpu"))):
        meta = _meta(M, tmp / name, **meta_kw)
        grid = sim_j.cfg.grid if M is J else Grid(sim_j.cfg.grid.cmin, sim_j.cfg.grid.shape)
        kern_m = kern if M is J else T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=0.02)
        out = Out(meta, kern_m, grid, sim_j.n_live)
        for c, s in enumerate(states, start=1):
            out.save(c, conv(s))
        out.close()
        outs[name] = tmp / name
    return outs


def test_single_file_and_grid_cells_equal_jax(h5, tmp_path):
    outs = _write_both(h5, tmp_path, export_grid_cells=True)
    for fn in ("Tiny.vtkhdf", "Tiny_GridCells.vtkhdf"):
        _assert_same_files(h5, outs["jax"] / fn, outs["port"] / fn)
    from sphexample_tpu_torch.io.vtkhdf import read_transient_polydata

    steps = list(read_transient_polydata(str(outs["port"] / "Tiny.vtkhdf")))
    assert len(steps) == 3 and set(steps[0][2]) == set(VARS)


def test_multi_file_mode_equals_jax(h5, tmp_path):
    outs = _write_both(h5, tmp_path, export_single_vtkhdf=False, export_grid_cells=True)
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"]))
    assert "Tiny_000003.vtkhdf" in names and "Tiny_GridCells_000003.vtkhdf" in names
    for fn in names:
        _assert_same_files(h5, outs["jax"] / fn, outs["port"] / fn)


def test_resume_truncates_and_appends(h5, tmp_path):
    from sphexample_tpu.io.output import OutputManager as JOut
    from sphexample_tpu_torch.io.output import make_save_callback
    from sphexample_tpu_torch.io.vtkhdf import read_transient_polydata

    sim_j, states = _jax_states(tmp_path / "src", n=4)
    port_states = [T.state_from_numpy(_leaves(s), "cpu") for s in states]
    sim = _tiny(T, tmp_path / "port", export_grid_cells=True)
    save = make_save_callback(sim)
    for c, s in enumerate(port_states[:3], start=1):
        save(c, s)
    save.close()
    # resume from the checkpoint of counter 2: snapshot 3 is dropped, 4 appended
    save = make_save_callback(sim, resume_counter=2)
    save(3, port_states[3])
    save.close()
    out = JOut(_meta(J, tmp_path / "jax", export_grid_cells=True), sim_j.cfg.spec.kernel,
               sim_j.cfg.grid, sim_j.n_live)
    for c, s in enumerate(states[:2] + states[3:], start=1):
        out.save(c, s)
    out.close()
    for fn in ("Tiny.vtkhdf", "Tiny_GridCells.vtkhdf"):
        _assert_same_files(h5, tmp_path / "jax" / fn, tmp_path / "port" / fn)
    got = list(read_transient_polydata(str(tmp_path / "port" / "Tiny.vtkhdf"),
                                       variables=["Density", "ID"]))
    assert len(got) == 3
    for (t, pts, data), s in zip(got, port_states[:2] + port_states[3:]):
        n = sim.n_live
        assert t == float(s.total_time)
        np.testing.assert_array_equal(pts[:, :2], s.particles.position[:n].numpy())
        np.testing.assert_array_equal(data["Density"], s.particles.density[:n].numpy())
        np.testing.assert_array_equal(data["ID"], s.particles.id[:n].numpy())
    # resuming with other output variables is refused
    sim2 = _tiny(T, tmp_path / "port")
    sim2.meta = T.replace(sim2.meta, output_variables=("Density",))
    with pytest.raises(ValueError, match="cannot append"):
        make_save_callback(sim2, resume_counter=1)


def test_close_manually_and_clean_folder(h5, tmp_path):
    from sphexample_tpu_torch.io.vtkhdf import (clean_simulation_folder,
                                                close_hdf_vtk_manually)

    outs = _write_both(h5, tmp_path, export_grid_cells=True)
    d = outs["port"]
    assert close_hdf_vtk_manually(str(d)) == []
    bad = d / "Broken.vtkhdf"
    bad.write_bytes(b"not an hdf5 file")
    (d / "keep.txt").write_text("x")
    assert close_hdf_vtk_manually(str(d)) == [str(bad)]
    assert close_hdf_vtk_manually(str(d / "missing")) == []
    clean_simulation_folder(str(d))
    assert os.listdir(d) == ["keep.txt"]
    clean_simulation_folder(str(d / "missing"))


def test_four_slab_save_equals_the_single_device_save(h5, tmp_path):
    from sphexample_tpu_torch.io.output import OutputManager

    sim = _tiny(T, tmp_path, capacity=96, export_grid_cells=True)
    state = make_fixed_steps_fn(sim.cfg, 6)(sim.state)
    slabs = split_state(state, [torch.device("cpu")] * 4)
    for name, s in (("one", state), ("four", slabs)):
        meta = T.replace(sim.meta, save_location=str(tmp_path / name))
        out = OutputManager(meta, sim.cfg.spec.kernel, sim.cfg.grid, sim.n_live)
        out.save(1, s)
        out.close()
    for fn in ("Tiny.vtkhdf", "Tiny_GridCells.vtkhdf"):
        _assert_same_files(h5, tmp_path / "one" / fn, tmp_path / "four" / fn)


def test_async_output_matches_sync(h5, tmp_path):
    """tests/test_aux.py:374 for the port: run_simulation with the
    asynchronous saver writes the same VTKHDF as the synchronous path."""
    from sphexample_tpu_torch.io.output import make_save_callback

    files = {}
    for mode in (True, False):
        sim = _tiny(T, tmp_path / str(mode), async_output=mode, export_grid_cells=True)
        save = make_save_callback(sim)
        T.run_simulation(sim, save_callback=save, max_intervals=3)
        save.close()
        files[mode] = tmp_path / str(mode)
    for fn in ("Tiny.vtkhdf", "Tiny_GridCells.vtkhdf"):
        _assert_same_files(h5, files[True] / fn, files[False] / fn)
    with h5.File(files[True] / "Tiny.vtkhdf", "r") as f:
        assert int(f["VTKHDF"]["Steps"].attrs["NSteps"]) == 4
    # the initial snapshot has no cell list yet (cell_start is zeros until
    # the first step rebuilds): no grid step for it, as in the JAX package
    with h5.File(files[True] / "Tiny_GridCells.vtkhdf", "r") as f:
        assert int(f["VTKHDF"]["Steps"].attrs["NSteps"]) == 3
