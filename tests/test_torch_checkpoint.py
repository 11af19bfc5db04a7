"""Checkpoints of the port on the CPU: a save and load round trip bit for
bit, files that cross between the port and the JAX package (the JAX key
format, ``f::`` + ``keystr`` of the leaf's path), capacity padding with ``id
= -1``, the grid a re-gridded run resumes on, and a resumed run equal to the
straight run bit for bit in f64."""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.core.step import make_fixed_steps_fn as j_fixed
from sphexample_tpu.io.checkpoint import load_checkpoint as j_load
from sphexample_tpu.io.checkpoint import save_checkpoint as j_save
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.io.checkpoint import (load_checkpoint, resume_simulation,
                                                save_checkpoint)
from sphexample_tpu_torch.state import split_state, state_tensors
from test_torch_driver import tiny

torch.set_num_threads(1)


def _tiny(M, capacity=None):
    return tiny(M, capacity=capacity)


def _digest(state) -> str:
    h = hashlib.sha256(str(state.rebuilds).encode())
    for k, v in state_tensors(state).items():
        h.update(k.encode() + str(v.dtype).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _stepped(n=7, **kw):
    sim = _tiny(T, **kw)
    sim.state = make_fixed_steps_fn(sim.cfg, n)(sim.state)
    return sim


def test_round_trip_bit_for_bit(tmp_path):
    sim = _stepped()
    assert sim.state.rebuilds > 0
    path = str(tmp_path / "sub" / "ck.npz")
    save_checkpoint(path, sim.state, 5, grid=sim.cfg.grid)
    fresh = _tiny(T)
    state, counter = load_checkpoint(path, fresh.state)
    assert counter == 5 and _digest(state) == _digest(sim.state)
    with np.load(path) as f:
        keys = set(f.files)
    assert {"f::.particles.position", "f::.cell_start", "f::.total_time", "f::.max_halo",
            "f::.grid_escapes", "counter", "capacity", "rebuilds", "grid_cmin",
            "grid_shape"} <= keys
    assert not any("pallas" in k or "block_tables" in k for k in keys)


def test_a_sharded_state_is_gathered_on_save(tmp_path):
    sim = _stepped(capacity=96)
    slabs = split_state(sim.state, [torch.device("cpu")] * 4)
    save_checkpoint(str(tmp_path / "a.npz"), slabs, 2)
    state, _ = load_checkpoint(str(tmp_path / "a.npz"), _tiny(T, capacity=96).state)
    assert _digest(state) == _digest(sim.state)


def _jax_leaves(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "particles":
            out.update({g.name: np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        elif hasattr(v, "shape") and f.name not in ("max_chunks",):
            out[f.name] = np.asarray(v)
    return out


def _port_leaves(state):
    out = {f.name: getattr(state.particles, f.name).numpy()
           for f in dataclasses.fields(state.particles)}
    out.update({k: v.numpy() for k, v in state_tensors(state).items() if "." not in k})
    return out


def _assert_same(jax_state, port_state):
    a, b = _jax_leaves(jax_state), _port_leaves(port_state)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_files_cross_between_the_packages(tmp_path):
    sim_j = _tiny(J)
    sj = j_fixed(sim_j.cfg, 7)(sim_j.state)
    j_save(str(tmp_path / "j.npz"), sj, 4, cfg=sim_j.cfg)
    st, counter = load_checkpoint(str(tmp_path / "j.npz"), _tiny(T).state)
    assert counter == 4 and st.rebuilds == 0  # JAX keeps no host count
    _assert_same(sj, st)
    # and back: a port-written file loads into JAX's loader
    st = st.replace(rebuilds=3)
    save_checkpoint(str(tmp_path / "t.npz"), st, 6, grid=_tiny(T).cfg.grid)
    back, counter = j_load(str(tmp_path / "t.npz"), _tiny(J).state)
    assert counter == 6
    _assert_same(back, st)
    assert int(back.max_chunks) == 0


def test_a_file_without_grid_escapes_loads(tmp_path):
    sim = _stepped()
    save_checkpoint(str(tmp_path / "a.npz"), sim.state, 2)
    with np.load(str(tmp_path / "a.npz")) as f:
        data = {k: f[k] for k in f.files if k != "f::.grid_escapes"}
    np.savez(str(tmp_path / "b.npz"), **data)
    state, _ = load_checkpoint(str(tmp_path / "b.npz"), sim.state)
    assert int(state.grid_escapes) == 0
    del data["f::.total_time"]
    np.savez(str(tmp_path / "c.npz"), **data)
    with pytest.raises(ValueError, match="missing state leaf '.total_time'"):
        load_checkpoint(str(tmp_path / "c.npz"), sim.state)
    np.savez(str(tmp_path / "d.npz"), counter=1, leaf_0=np.zeros(3))
    with pytest.raises(ValueError, match="legacy"):
        load_checkpoint(str(tmp_path / "d.npz"), sim.state)


def test_capacity_padding_and_resume_growth(tmp_path):
    small = _stepped()
    cap = small.state.particles.capacity
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, small.state, 3)
    # into a larger template: the new rows are inactive, id -1
    big = _tiny(T, capacity=cap + 40)
    state, _ = load_checkpoint(path, big.state)
    p = state.particles
    assert p.capacity == cap + 40
    assert (p.id[cap:] == -1).all() and not p.active[cap:].any()
    assert torch.equal(p.position[:cap], small.state.particles.position)
    with pytest.raises(ValueError, match="exceeds"):
        load_checkpoint(str(_save(tmp_path / "b.npz", state)), small.state)
    # resume_simulation grows a smaller simulation to the file's capacity
    sim, counter = resume_simulation(_tiny(T), str(tmp_path / "b.npz"))
    assert counter == 3 and sim.state.particles.capacity == cap + 40
    assert (sim.state.particles.id[cap:] == -1).all()
    out = T.run_simulation(sim, start_counter=counter, max_intervals=1)
    assert torch.isfinite(out.state.particles.density).all()


def _save(path, state):
    save_checkpoint(str(path), state, 3)
    return path


def test_resumed_run_equals_the_straight_run(tmp_path):
    """Run 3 intervals with a checkpoint at every counter; resume a fresh
    assembly from counter 3 and run 1 more: the straight run's state at
    counter 4, bit for bit (f64, CPU)."""
    sim = _tiny(T)
    digests = {}

    def save(counter, state):
        save_checkpoint(str(tmp_path / f"ck_{counter}.npz"), state, counter, grid=sim.cfg.grid)
        digests[counter] = _digest(state)

    T.run_simulation(sim, save_callback=save, max_intervals=3)
    assert sorted(digests) == [1, 2, 3, 4]
    fresh, counter = resume_simulation(_tiny(T), str(tmp_path / "ck_3.npz"))
    assert counter == 3 and _digest(fresh.state) == digests[3]
    T.run_simulation(fresh, start_counter=counter, max_intervals=1)
    assert _digest(fresh.state) == _digest(sim.state) == digests[4]


def _escape(M):
    """tests/test_aux.py:477-541 (see tests/test_torch_driver.py)."""
    rng = np.random.default_rng(7)
    const = M.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    pos = rng.uniform(0, 0.3, size=(200, 2))
    meta = M.SimulationMetaData(simulation_name="esc", save_location=".", dims=2,
                                simulation_time=0.03, output_times=0.01, block_size=64,
                                dtype="float64", grid_margin_cells=2)
    sim = M.assemble_simulation(pos, np.full(200, const.rho0), np.ones(200, np.int32),
                                np.ones(200, np.int32), np.arange(1, 201), meta, const,
                                kern, M.ViscosityModel.ARTIFICIAL,
                                M.DensityDiffusionModel.ZERO, device="cpu")
    p = sim.state.particles
    vel = torch.zeros_like(p.velocity)
    vel[0, 0] = 30.0
    pos2 = p.position.clone()
    pos2[0] = torch.tensor([0.45, 0.15], dtype=pos2.dtype)
    sim.state = sim.state.replace(particles=p.replace(velocity=vel, position=pos2))
    return sim


def test_a_regridded_run_resumes_on_its_grid(tmp_path):
    sim = _escape(T)
    grid0 = sim.cfg.grid
    grids = {}

    def save(counter, state):
        save_checkpoint(str(tmp_path / f"ck_{counter}.npz"), state, counter, grid=sim.cfg.grid)
        grids[counter] = sim.cfg.grid

    T.run_simulation(sim, save_callback=save, max_intervals=3)
    assert grids[2] != grid0 and grids[4] == sim.cfg.grid
    fresh, counter = resume_simulation(_escape(T), str(tmp_path / "ck_2.npz"))
    assert fresh.cfg.grid == grids[2]
    T.run_simulation(fresh, start_counter=counter, max_intervals=2)
    assert fresh.cfg.grid == sim.cfg.grid
    assert _digest(fresh.state) == _digest(sim.state)


def test_sharded_resume_ends_on_the_straight_run(tmp_path):
    """A checkpoint of a sharded run resumed straight into a sharded
    simulation (the JAX ``resume_simulation`` takes one too: its sharded
    interval function runs on the loaded global arrays) and run one interval
    more ends bit for bit where the uninterrupted sharded run ends; a
    checkpoint larger than the sharded capacity is refused."""
    from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation

    mesh = make_mesh(4, "cpu")
    ref = T.run_simulation(shard_simulation(_tiny(T), mesh), max_intervals=2)
    first = T.run_simulation(shard_simulation(_tiny(T), mesh), max_intervals=1)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, first.state, 2, grid=first.cfg.grid)
    sim, counter = resume_simulation(shard_simulation(_tiny(T), mesh), path)
    assert counter == 2 and isinstance(sim.state, tuple) and len(sim.state) == 4
    assert sim.cfg.halo == first.cfg.halo and sim.mesh is mesh
    sim = T.run_simulation(sim, max_intervals=1, start_counter=counter)
    a, b = T.state_to_numpy(ref.state), T.state_to_numpy(sim.state)
    assert int(a["iteration"]) == int(b["iteration"]) > 0
    assert float(a["total_time"]) == float(b["total_time"])
    for k in ("position", "velocity", "density", "pressure", "id"):
        np.testing.assert_array_equal(b[f"particles.{k}"], a[f"particles.{k}"], err_msg=k)

    big = _tiny(T, capacity=4096)
    save_checkpoint(str(tmp_path / "big.npz"), big.state, 2)
    with pytest.raises(ValueError, match="sharded"):
        resume_simulation(shard_simulation(_tiny(T), mesh), str(tmp_path / "big.npz"))


def test_jax_resumes_a_sharded_simulation(tmp_path):
    """The reference behaviour the port's sharded resume follows: the JAX
    ``resume_simulation`` takes a sharded simulation (4 of the conftest's
    virtual CPU devices, its all-gather path) and ends bit for bit where
    its uninterrupted sharded run ends."""
    from sphexample_tpu.io.checkpoint import resume_simulation as j_resume
    from sphexample_tpu.parallel.mesh import make_mesh as j_mesh
    from sphexample_tpu.parallel.mesh import shard_simulation as j_shard

    mesh = j_mesh(4)
    ref = J.run_simulation(j_shard(_tiny(J), mesh), max_intervals=2)
    first = J.run_simulation(j_shard(_tiny(J), mesh), max_intervals=1)
    path = str(tmp_path / "ck.npz")
    j_save(path, first.state, 2, cfg=first.cfg)
    sim, counter = j_resume(j_shard(_tiny(J), mesh), path)
    assert counter == 2 and sim.cfg.ctx.is_sharded
    sim = J.run_simulation(sim, max_intervals=1, start_counter=counter)
    assert int(sim.state.iteration) == int(ref.state.iteration) > 0
    for k in ("position", "velocity", "density", "pressure", "id"):
        np.testing.assert_array_equal(np.asarray(getattr(sim.state.particles, k)),
                                      np.asarray(getattr(ref.state.particles, k)), err_msg=k)


def test_sharded_resume_in_the_cli_order_matches_the_continuous_run(tmp_path):
    """tests/test_sharded.py:494-536 for the port: a sharded run saved at an
    interval boundary, resumed into a fresh single-device assembly and then
    sharded (the CLI's ``--resume`` + ``--shard`` order), ends where the
    uninterrupted sharded run ends."""
    from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation

    mesh = make_mesh(4, "cpu")
    ref = T.run_simulation(shard_simulation(_tiny(T), mesh), max_intervals=2)
    first = T.run_simulation(shard_simulation(_tiny(T), mesh), max_intervals=1)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, first.state, 2, grid=first.cfg.grid)
    sim, counter = resume_simulation(_tiny(T), path)
    assert counter == 2
    sim = T.run_simulation(shard_simulation(sim, mesh), max_intervals=1,
                           start_counter=counter)
    a, b = T.state_to_numpy(ref.state), T.state_to_numpy(sim.state)
    assert int(a["iteration"]) == int(b["iteration"]) > 0
    assert float(a["total_time"]) == float(b["total_time"])
    for k in ("position", "velocity", "density", "pressure"):
        np.testing.assert_array_equal(b[f"particles.{k}"], a[f"particles.{k}"], err_msg=k)


def test_jax_resume_of_a_port_file_continues(tmp_path):
    """A port checkpoint resumed by the JAX package and run on agrees with
    the port's own continuation within tests/test_trajectory.py:64-70."""
    sim = _stepped()
    save_checkpoint(str(tmp_path / "a.npz"), sim.state, 2)
    from sphexample_tpu.io.checkpoint import resume_simulation as j_resume

    sim_j, counter = j_resume(_tiny(J), str(tmp_path / "a.npz"))
    J.run_simulation(sim_j, start_counter=counter, max_intervals=1)
    T.run_simulation(sim, start_counter=counter, max_intervals=1)
    a = jnp.asarray(sim_j.state.particles.position)
    ids_j = np.asarray(sim_j.state.particles.id)
    ids_t = sim.state.particles.id.numpy()
    pj = np.asarray(a)[np.argsort(ids_j)][ids_j[np.argsort(ids_j)] > 0]
    pt = sim.state.particles.position.numpy()[np.argsort(ids_t)][ids_t[np.argsort(ids_t)] > 0]
    np.testing.assert_allclose(pt, pj, rtol=1e-9, atol=1e-9 * float(np.abs(pj).max()))
    assert float(sim.state.total_time) == pytest.approx(float(sim_j.state.total_time),
                                                        rel=1e-12)
