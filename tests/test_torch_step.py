"""The slice as a whole on the CPU: the port's step against the JAX package's,
started from one identical state (``state_from_numpy``), in f64 on a coarse
3D dam break (ARTIFICIAL + LINEAR, the main path's models), with the bands of
test_trajectory.py; plus ``adaptive_dt``, the ``position_half`` quirk, the
rebuild cadence and the interval loop; the mDBC step on the mini
still-wedge of test_trajectory.py against the JAX package and the numpy
``reference_run``; and the MovingSquare mode set (prescribed motion, PLANAR
shifting, LAMINAR_SPS, kernel output) on the mini moving square of
test_trajectory.py through the cell sweep, with the sweep-kernel rule of
``assemble_simulation`` held against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from reference_impl import reference_run
from sphexample_tpu.core.step import make_fixed_steps_fn as j_fixed
from sphexample_tpu.core.step import sph_step as j_step
from sphexample_tpu.ops.timestep import adaptive_dt as j_dt
from sphexample_tpu.ops.pallas_block_sweep import BLOCK_CAP_LIMIT as J_BLOCK_CAP_LIMIT
from sphexample_tpu_torch.core.driver import BLOCK_CAP_LIMIT, choose_sweep_kernel
from sphexample_tpu_torch.core.step import make_fixed_steps_fn as t_fixed
from sphexample_tpu_torch.core.step import make_interval_fn
from sphexample_tpu_torch.core.step import sph_step as t_step
from sphexample_tpu_torch.io.casegen import dam_break_3d
from sphexample_tpu_torch.ops.timestep import adaptive_dt as t_dt

torch.set_num_threads(1)
OFF = 0.0037  # off the map_floor half-integer boundary (test_trajectory.py)
DX = 0.05


def _case(M, block_size=256):
    const = M.SimulationConstants(dx=DX, c0=33.14, alpha=0.1, m0=1000 * DX**3, cfl=0.2)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * DX**2)))
    meta = M.SimulationMetaData(simulation_name="torch_step", save_location=".",
                                dims=3, dtype="float64", block_size=block_size)
    return meta, const, kern


def _assemble_jax():
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    meta, const, kern = _case(J)
    return J.assemble_simulation(pos + OFF, dens, ptype, grp, idp, meta, const,
                                 kern, J.ViscosityModel.ARTIFICIAL,
                                 J.DensityDiffusionModel.LINEAR)


def _assemble_port():
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    meta, const, kern = _case(T)
    return T.assemble_simulation(pos + OFF, dens, ptype, grp, idp, meta, const,
                                 kern, T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cpu")


def _leaves(state):
    """A JAX SimulationState as the flat dict of numpy leaves."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "particles":
            out.update({f"particles.{g.name}": np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
    return out


def _by_id(ids, a):
    ids = np.asarray(ids)
    live = ids > 0
    return np.asarray(a)[live][np.argsort(ids[live], kind="stable")]


def _started_pair(fluid_vz=0.0):
    """A JAX state 5 steps in (sorted, position_half set), and the port's
    copy of it."""
    sim_j = _assemble_jax()
    state = sim_j.state
    if fluid_vz:
        p = state.particles
        v = p.velocity.at[:, 2].set(jnp.where(p.ptype == 1, fluid_vz, 0.0))
        state = state.replace(particles=p.replace(velocity=v))
    state = j_fixed(sim_j.cfg, 5)(state)
    sim_t = _assemble_port()
    return sim_j, state, sim_t, T.state_from_numpy(_leaves(state), "cpu")


def test_trajectory_20_steps_matches_jax():
    sim_j, sj, sim_t, st = _started_pair()
    fj = j_fixed(sim_j.cfg, 20)(sj)
    ft = t_fixed(sim_t.cfg, 20)(st)
    ref = {k: _by_id(fj.particles.id, getattr(fj.particles, f))
           for k, f in (("pos", "position"), ("vel", "velocity"), ("dens", "density"))}
    fw = {k: _by_id(ft.particles.id.numpy(), getattr(ft.particles, f).numpy())
          for k, f in (("pos", "position"), ("vel", "velocity"), ("dens", "density"))}
    # test_trajectory.py:64-70
    scale = float(np.abs(ref["pos"]).max())
    assert float(ft.total_time) == pytest.approx(float(fj.total_time), rel=1e-12)
    assert float(ft.current_dt) == pytest.approx(float(fj.current_dt), rel=1e-12)
    np.testing.assert_allclose(fw["pos"], ref["pos"], rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(fw["vel"], ref["vel"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(fw["dens"], ref["dens"], rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(fj.cell_start), ft.cell_start.numpy())
    np.testing.assert_array_equal(np.asarray(fj.particles.id), ft.particles.id.numpy())
    assert int(ft.iteration) == int(fj.iteration) == 25
    assert int(ft.max_segment) == int(fj.max_segment)
    assert int(ft.occupied_cells) == int(fj.occupied_cells)
    # the column fell
    assert fw["vel"][:, 2].min() < -0.05


def test_state_numpy_roundtrip():
    _, sj, _, st = _started_pair()
    leaves = _leaves(sj)
    back = T.state_to_numpy(st)
    assert set(back) <= set(leaves)
    for k, v in back.items():
        assert v.dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)
    with pytest.raises(KeyError):
        T.state_from_numpy({k: v for k, v in back.items() if k != "cell_start"}, "cpu")


@pytest.mark.parametrize("dx_acc", [0.0, 10.0])
def test_position_half_not_permuted(dx_acc):
    """The displacement accumulator reads position_half in its stored row
    order, never permuted by a resort (reference scratch-array quirk) -
    with and without a rebuild in the step."""
    sim_j, sj, sim_t, st = _started_pair()
    rng = np.random.default_rng(0)
    ph = np.asarray(sj.position_half) + rng.normal(0, 1e-3, sj.position_half.shape)
    sj = sj.replace(position_half=jnp.asarray(ph))
    st = st.replace(position_half=torch.as_tensor(ph))
    nj, dj = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))(sj, jnp.asarray(dx_acc))
    nt, dt_ = t_step(sim_t.cfg, st, torch.tensor(dx_acc, dtype=torch.float64))
    expect = dx_acc + 4.0 * np.sqrt(((ph - np.asarray(sj.particles.position)) ** 2)
                                    .sum(-1).max())
    rebuilt = expect >= sim_t.cfg.spec.kernel.h
    assert float(dt_) == pytest.approx(0.0 if rebuilt else expect, abs=1e-15)
    assert float(dj) == pytest.approx(float(dt_), abs=1e-15)
    assert nt.rebuilds == st.rebuilds + int(rebuilt)
    np.testing.assert_allclose(nt.position_half.numpy(), np.asarray(nj.position_half),
                               rtol=1e-12, atol=1e-14)


def test_rebuild_cadence_matches_jax():
    """A column falling at 12 m/s rebuilds every few steps: the port takes
    its lazy rebuilds on the same steps as the JAX package."""
    sim_j, sj, sim_t, st = _started_pair(fluid_vz=-12.0)
    step_j = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))
    h = sim_t.cfg.spec.kernel.h
    dj = jnp.asarray(1.0 + h)
    dt_ = torch.tensor(1.0 + h, dtype=torch.float64)
    r0 = st.rebuilds
    taken_j, taken_t = [], []
    for k in range(20):
        sj, dj = step_j(sj, dj)
        n_before = st.rebuilds
        st, dt_ = t_step(sim_t.cfg, st, dt_)
        taken_j.append(float(dj) == 0.0)
        taken_t.append(st.rebuilds > n_before)
    assert taken_t == taken_j
    assert st.rebuilds - r0 == sum(taken_j) >= 3


def test_adaptive_dt_parity():
    rng = np.random.default_rng(7)
    meta, jconst, jkern = _case(J)
    _, tconst, tkern = _case(T)
    pos = rng.normal(0, 0.5, (300, 3))
    vel = rng.normal(0, 1.0, (300, 3))
    acc = rng.normal(0, 10.0, (300, 3))
    acc[:40] = 0.0  # zero acceleration -> inf, never the minimum
    a = float(j_dt(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc), jconst, jkern))
    b = float(t_dt(torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(acc),
                   tconst, tkern))
    assert b == pytest.approx(a, rel=1e-14)
    z = torch.zeros(300, 3, dtype=torch.float64)
    # all-zero acceleration: the acoustic limit alone, finite
    c = float(t_dt(torch.as_tensor(pos), z, z, tconst, tkern))
    assert c == pytest.approx(tconst.cfl * tkern.h / tconst.c0, rel=1e-14)


def test_interval_runs_to_output_time_and_catches_divergence():
    sim = _assemble_port()
    interval = make_interval_fn(sim.cfg)
    st = interval(sim.state, 0.002)
    t = float(st.total_time)
    assert t > 0.002 and t - float(st.current_dt) <= 0.002 and int(st.iteration) > 0
    bad = st.replace(particles=st.particles.replace(
        velocity=st.particles.velocity * float("nan")))
    with pytest.raises(FloatingPointError):
        interval(bad, t + 0.002)


def test_run_simulation_and_unported_modes():
    sim = _assemble_port()
    meta = T.replace(sim.meta, output_times=0.001, simulation_time=0.0025)
    sim.meta = meta
    logs = []
    T.run_simulation(sim, log_callback=logs.append)
    assert len(logs) == 3 and logs[-1]["total_time"] > 0.0025
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    _, const, kern = _case(T)
    # shifting is ported: it assembles and runs (the plain sweep on the CPU)
    sim_s = T.assemble_simulation(pos + OFF, dens, ptype, grp, idp,
                                  T.replace(sim.meta, shifting=T.ShiftingMode.PLANAR),
                                  const, kern, T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device="cpu")
    shifted = t_fixed(sim_s.cfg, 2)(sim_s.state)
    assert torch.isfinite(shifted.particles.position).all()
    # mDBC is ported: it assembles, and without ghost rows it changes nothing
    sim_m = T.assemble_simulation(pos + OFF, dens, ptype, grp, idp,
                                  T.replace(sim.meta, mdbc=T.MDBCMode.SIMPLE),
                                  const, kern, T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device="cpu")
    assert sim_m.cfg.boundary_capacity == 1
    a = t_fixed(sim_m.cfg, 2)(sim_m.state)
    b = t_fixed(_assemble_port().cfg, 2)(_assemble_port().state)
    assert torch.equal(a.particles.density, b.particles.density)
    # prescribed motion is ported: the table is built from the geometries, and
    # a motion for a marker no MOVING row carries changes nothing
    moving = T.Geometry("", 1, T.ParticleType.MOVING,
                        T.MotionDetails(1.0, 0.0, 1.0, (1.0, 0.0, 0.0)))
    sim_v = T.assemble_simulation(pos + OFF, dens, ptype, grp, idp, sim.meta, const,
                                  kern, T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device="cpu",
                                  geometries=(moving,))
    assert sim_v.cfg.motion.any_motion and sim_v.cfg.motion.velocity == (0.0, 1.0)
    c = t_fixed(sim_v.cfg, 2)(sim_v.state)
    assert torch.equal(c.particles.position, b.particles.position)


def test_run_simulation_raises_on_grid_escape():
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    meta, const, kern = _case(T)
    meta = T.replace(meta, grid_margin_cells=0, output_times=0.001,
                     simulation_time=0.01)
    sim = T.assemble_simulation(pos + OFF, dens, ptype, grp, idp, meta, const, kern,
                                T.ViscosityModel.ARTIFICIAL,
                                T.DensityDiffusionModel.LINEAR, device="cpu")
    grid0 = sim.cfg.grid
    p = sim.state.particles
    p.position[np.argmax(ptype == 1), 2] += 5.0  # one fluid particle far above
    start = sim.state
    with pytest.raises(RuntimeError, match="escaped"):
        T.run_simulation(sim, max_intervals=1, auto_retune=False)
    # by default the driver grows the grid and replays the interval
    T.run_simulation(sim, max_intervals=1)
    assert sim.cfg.grid.ncells > grid0.ncells and int(sim.state.grid_escapes) == 0
    assert sim.state is not start and float(sim.state.total_time) > 0.001


N_STEPS = 50  # test_trajectory.py:34


def _wedge(M, **kw):
    """The mini still-wedge of test_trajectory.py:74-117: an mDBC floor under
    a falling fluid block, ARTIFICIAL + LINEAR, f64, ``OFF`` lattice shift."""
    const = M.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    dx = const.dx
    xs, zs = np.meshgrid(np.arange(10), np.arange(10), indexing="ij")
    fluid = np.stack([xs.ravel() * dx, zs.ravel() * dx + dx], axis=-1)
    floor_x = np.arange(-4, 14) * dx
    floor = np.stack([floor_x, np.zeros_like(floor_x)], axis=-1)
    pos = np.concatenate([floor, fluid]) + OFF
    nb, n = len(floor), len(floor) + len(fluid)
    ptype = np.concatenate([np.full(nb, 2), np.full(len(fluid), 1)]).astype(np.int32)
    ghost = np.zeros_like(pos)
    ghost[:nb] = floor + OFF + np.array([0.0, dx])
    ghostn = np.concatenate([np.tile(np.array([[0.0, dx]]), (nb, 1)),
                             np.zeros((n - nb, 2))])
    gm = np.concatenate([np.full(nb, 1), np.full(len(fluid), 2)]).astype(np.int32)
    ids = np.arange(1, n + 1)
    dens0 = np.full(n, const.rho0)
    meta = M.SimulationMetaData(simulation_name="traj_wedge", save_location=".",
                                dims=2, dtype="float64", mdbc=M.MDBCMode.SIMPLE,
                                grid_margin_cells=4)
    sim = M.assemble_simulation(pos, dens0, ptype, gm, ids, meta, const, kern,
                                M.ViscosityModel.ARTIFICIAL,
                                M.DensityDiffusionModel.LINEAR,
                                ghost_points=ghost, ghost_normals=ghostn, **kw)
    arrays = dict(pos=pos, dens=dens0, ptype=ptype, group_marker=gm, ids=ids,
                  ghost_points=ghost)
    return sim, const, kern, arrays


def _final(ids, p, to_np):
    return {k: _by_id(ids, to_np(getattr(p, f)))
            for k, f in (("pos", "position"), ("vel", "velocity"), ("dens", "density"))}


def _bands(fw, ref, t_fw, t_ref, dt_fw, dt_ref):
    """test_trajectory.py:64-70."""
    scale = float(np.abs(ref["pos"]).max())
    assert t_fw == pytest.approx(t_ref, rel=1e-12)
    assert dt_fw == pytest.approx(dt_ref, rel=1e-12)
    np.testing.assert_allclose(fw["pos"], ref["pos"], rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(fw["vel"], ref["vel"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(fw["dens"], ref["dens"], rtol=1e-9, atol=1e-6)


def test_trajectory_wedge_mdbc_matches_jax_and_reference():
    sim_t, const, kern, arrays = _wedge(T, device="cpu")
    # full-length ghost arrays (zero rows for the fluid), as test_trajectory.py
    # passes them: 18 live slots and 100 fill slots that index row 0
    assert sim_t.cfg.boundary_capacity == 118
    ft = t_fixed(sim_t.cfg, N_STEPS)(sim_t.state)
    fw = _final(ft.particles.id.numpy(), ft.particles, lambda a: a.numpy())

    sim_j, *_ = _wedge(J)
    assert sim_j.cfg.boundary_capacity == sim_t.cfg.boundary_capacity
    fj = j_fixed(sim_j.cfg, N_STEPS)(sim_j.state)
    jx = _final(fj.particles.id, fj.particles, np.asarray)
    _bands(fw, jx, float(ft.total_time), float(fj.total_time),
           float(ft.current_dt), float(fj.current_dt))
    np.testing.assert_array_equal(np.asarray(fj.particles.id), ft.particles.id.numpy())

    ref = reference_run(kernel_family="wendland", kern=kern, const=const,
                        viscosity="artificial", diffusion="linear", shifting=False,
                        kernel_output=False, mdbc=True, motion={}, n_steps=N_STEPS,
                        **arrays)
    _bands(fw, ref, float(ft.total_time), float(ref["total_time"]),
           float(ft.current_dt), float(ref["dts"][-1]))
    # the trajectory did something: the fluid fell and mDBC corrected the floor
    assert fw["dens"].max() > const.rho0 + 1e-3
    assert np.abs(fw["dens"][:18] - const.rho0).max() > 1e-6


def test_mdbc_state_roundtrip_and_single_step():
    """A JAX mDBC state 5 steps in goes through ``state_from_numpy`` into the
    port (ghost points and normals included); one step on each side agrees."""
    sim_j, *_ = _wedge(J)
    sj = j_fixed(sim_j.cfg, 5)(sim_j.state)
    sim_t, *_ = _wedge(T, device="cpu")
    leaves = _leaves(sj)
    st = T.state_from_numpy(leaves, "cpu")
    back = T.state_to_numpy(st)
    for k in ("particles.ghost_points", "particles.ghost_normals"):
        assert np.abs(leaves[k]).max() > 0
        np.testing.assert_array_equal(back[k], leaves[k])
    h = sim_t.cfg.spec.kernel.h
    for dx_acc in (0.0, 1.0 + h):   # without and with a rebuild
        nj, _ = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))(sj, jnp.asarray(dx_acc))
        nt, _ = t_step(sim_t.cfg, st, torch.tensor(dx_acc, dtype=torch.float64))
        np.testing.assert_array_equal(np.asarray(nj.particles.id), nt.particles.id.numpy())
        for f, tol in (("density", 1e-12), ("position", 1e-12), ("velocity", 1e-9),
                       ("ghost_points", 0.0)):
            np.testing.assert_allclose(getattr(nt.particles, f).numpy(),
                                       np.asarray(getattr(nj.particles, f)),
                                       rtol=tol, atol=tol, err_msg=f)
        assert float(nt.total_time) == pytest.approx(float(nj.total_time), rel=1e-13)


def _square(M, speed=0.5, block_sweep=False, **kw):
    """The mini moving square of test_trajectory.py:211-262: a prescribed-motion
    body driving fluid, LAMINAR_SPS + LINEAR + PLANAR + STORE, k = sqrt 2, f64,
    ``OFF`` lattice shift; ``block_sweep`` as given (the deck's own default is
    True)."""
    const = M.SimulationConstants(dx=0.02, c0=30.0, cfl=0.3, g=0.0)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx, k=float(np.sqrt(2)))
    dx = const.dx
    xs, zs = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    fluid = np.stack([xs.ravel() * dx, zs.ravel() * dx], axis=-1)
    sq_x, sq_z = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    square = np.stack([(sq_x.ravel() - 5.0) * dx, (sq_z.ravel() + 4.0) * dx], axis=-1)
    pos = np.concatenate([square, fluid]) + OFF
    nm, n = len(square), len(square) + len(fluid)
    ptype = np.concatenate([np.full(nm, 3), np.full(len(fluid), 1)]).astype(np.int32)
    gm = np.concatenate([np.full(nm, 3), np.full(len(fluid), 2)]).astype(np.int32)
    ids = np.arange(1, n + 1)
    dens0 = np.full(n, const.rho0)
    meta = M.SimulationMetaData(simulation_name="traj_square", save_location=".",
                                dims=2, dtype="float64", shifting=M.ShiftingMode.PLANAR,
                                kernel_output=M.KernelOutputMode.STORE,
                                grid_margin_cells=4, block_sweep=block_sweep)
    motion = M.MotionDetails(velocity=speed, start_time=0.0, duration=10.0,
                             direction=(1.0, 0.0))
    sim = M.assemble_simulation(
        pos, dens0, ptype, gm, ids, meta, const, kern,
        M.ViscosityModel.LAMINAR_SPS, M.DensityDiffusionModel.LINEAR,
        geometries=(M.Geometry(csv_file="", group_marker=3, type=M.ParticleType.MOVING,
                               motion=motion),), **kw)
    arrays = dict(pos=pos, dens=dens0, ptype=ptype, group_marker=gm, ids=ids,
                  ghost_points=np.zeros_like(pos))
    return sim, const, kern, arrays, square


def test_trajectory_moving_square_matches_jax_and_reference():
    sim_t, const, kern, arrays, square = _square(T, device="cpu")
    assert sim_t.cfg.sweep_kernel == "cell"
    ft = t_fixed(sim_t.cfg, N_STEPS)(sim_t.state)
    fw = _final(ft.particles.id.numpy(), ft.particles, lambda a: a.numpy())

    sim_j, *_ = _square(J)
    fj = j_fixed(sim_j.cfg, N_STEPS)(sim_j.state)
    jx = _final(fj.particles.id, fj.particles, np.asarray)
    _bands(fw, jx, float(ft.total_time), float(fj.total_time),
           float(ft.current_dt), float(fj.current_dt))
    np.testing.assert_array_equal(np.asarray(fj.particles.id), ft.particles.id.numpy())
    # kernel output is written from the second sweep, as in the JAX package
    np.testing.assert_allclose(ft.particles.kernel_w.numpy(),
                               np.asarray(fj.particles.kernel_w), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ft.particles.kernel_grad.numpy(),
                               np.asarray(fj.particles.kernel_grad), rtol=1e-9, atol=1e-7)
    assert float(ft.particles.kernel_w.min()) > 0

    ref = reference_run(kernel_family="wendland", kern=kern, const=const,
                        viscosity="laminar_sps", diffusion="linear", shifting=True,
                        kernel_output=True, mdbc=False,
                        motion={3: (0.5, 0.0, 10.0, (1.0, 0.0))}, n_steps=N_STEPS,
                        **arrays)
    _bands(fw, ref, float(ft.total_time), float(ref["total_time"]),
           float(ft.current_dt), float(ref["dts"][-1]))
    # the square moved at the prescribed speed
    nm = len(square)
    expected_x = square[:, 0] + OFF + 0.5 * float(ft.total_time)
    np.testing.assert_allclose(fw["pos"][:nm, 0], expected_x, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(fw["vel"][:nm], np.tile([0.5, 0.0], (nm, 1)))


def test_moving_square_takes_the_block_sweep_by_default_and_matches_jax():
    """With the deck's default ``block_sweep=True`` the driver's rule picks
    the block sweep for the mini moving square, as it does for every deck
    under 2^21 rows whatever its models (in the JAX package too, with
    ``use_pallas``); 50 CPU steps of it (the plain version) still match the
    JAX package's run of the same deck within the bands of
    test_trajectory.py:64-70."""
    sim_t, *_ = _square(T, block_sweep=True, device="cpu")
    assert T.SimulationMetaData("d", ".").block_sweep is True
    assert sim_t.cfg.sweep_kernel == "block"
    ft = t_fixed(sim_t.cfg, N_STEPS)(sim_t.state)
    fw = _final(ft.particles.id.numpy(), ft.particles, lambda a: a.numpy())
    sim_j, *_ = _square(J, block_sweep=True)
    fj = j_fixed(sim_j.cfg, N_STEPS)(sim_j.state)
    jx = _final(fj.particles.id, fj.particles, np.asarray)
    _bands(fw, jx, float(ft.total_time), float(fj.total_time),
           float(ft.current_dt), float(fj.current_dt))
    np.testing.assert_allclose(ft.particles.kernel_w.numpy(),
                               np.asarray(fj.particles.kernel_w), rtol=1e-9, atol=1e-9)
    assert float(ft.particles.kernel_w.min()) > 0


def test_moving_square_state_roundtrip_and_rebuild_cadence():
    """A JAX moving-square state 5 steps in starts the port bit for bit
    (kernel sums, MOVING ``ptype`` and group markers included), and the port
    takes its lazy rebuilds on the same steps: the displacement accumulator
    sees the body's half-step advance, not ``motion_limiter * velocity``.
    The body moves at 5 m/s here, so that it alone forces a rebuild every
    dozen steps."""
    sim_j, *_ = _square(J, speed=5.0)
    sj = j_fixed(sim_j.cfg, 5)(sim_j.state)
    sim_t, *_ = _square(T, speed=5.0, device="cpu")
    leaves = _leaves(sj)
    st = T.state_from_numpy(leaves, "cpu")
    back = T.state_to_numpy(st)
    for k in ("particles.kernel_w", "particles.kernel_grad", "particles.ptype",
              "particles.group_marker", "particles.velocity", "position_half"):
        assert np.abs(leaves[k]).max() > 0, k
        assert back[k].dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    assert (leaves["particles.ptype"] == 3).sum() == 16

    step_j = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))
    h = sim_t.cfg.spec.kernel.h
    dj = jnp.asarray(1.0 + h)
    dt_ = torch.tensor(1.0 + h, dtype=torch.float64)
    taken_j, taken_t = [], []
    for _ in range(40):
        sj, dj = step_j(sj, dj)
        n_before = st.rebuilds
        st, dt_ = t_step(sim_t.cfg, st, dt_)
        taken_j.append(float(dj) == 0.0)
        taken_t.append(st.rebuilds > n_before)
        assert float(dt_) == pytest.approx(float(dj), rel=1e-9, abs=1e-15)
    assert taken_t == taken_j
    assert sum(taken_j) >= 2
    np.testing.assert_array_equal(np.asarray(sj.particles.id), st.particles.id.numpy())
    np.testing.assert_allclose(st.particles.position.numpy(),
                               np.asarray(sj.particles.position), rtol=1e-9, atol=1e-11)


def test_block_sweep_false_is_the_block_run_on_the_cpu():
    """20 steps of the coarse dam break with ``block_sweep=False``: on the CPU
    both kernels are the plain sweep, so the two runs agree bit for bit."""
    sim_b = _assemble_port()
    assert sim_b.cfg.sweep_kernel == "block"
    sim_c = _assemble_port()
    sim_c.cfg = dataclasses.replace(sim_c.cfg, sweep_kernel="cell")
    fb = t_fixed(sim_b.cfg, 20)(sim_b.state)
    fc = t_fixed(sim_c.cfg, 20)(sim_c.state)
    for f in ("position", "velocity", "density", "acceleration", "id"):
        assert torch.equal(getattr(fb.particles, f), getattr(fc.particles, f)), f
    assert float(fb.total_time) == float(fc.total_time)
    bad = dataclasses.replace(sim_c.cfg, sweep_kernel="pair")
    with pytest.raises(ValueError, match="pair"):
        t_fixed(bad, 1)(sim_c.state)


@pytest.mark.parametrize("block_sweep", [True, False])
def test_sweep_kernel_rule_matches_jax_rule(block_sweep):
    """The port's ``choose_sweep_kernel`` against what JAX ``assemble_simulation``
    does with the same flag: a chunk table (``ct_cap > 0``) means its block
    kernel, none its cell-pair kernel."""
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    meta, const, kern = _case(J)
    meta = J.replace(meta, use_pallas=True, block_sweep=block_sweep, dtype="float32")
    sim_j = J.assemble_simulation(pos + OFF, dens, ptype, grp, idp, meta, const, kern,
                                  J.ViscosityModel.ARTIFICIAL,
                                  J.DensityDiffusionModel.LINEAR)
    tmeta, tconst, tkern = _case(T)
    sim_t = T.assemble_simulation(pos + OFF, dens, ptype, grp, idp,
                                  T.replace(tmeta, block_sweep=block_sweep), tconst,
                                  tkern, T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device="cpu")
    assert (sim_j.cfg.ct_cap > 0) == (sim_t.cfg.sweep_kernel == "block") == block_sweep
    assert sim_t.cfg.sweep_kernel == choose_sweep_kernel(
        block_sweep, sim_t.state.particles.capacity)


def test_sweep_kernel_rule_capacity_boundary():
    assert BLOCK_CAP_LIMIT == J_BLOCK_CAP_LIMIT == 1 << 21
    assert choose_sweep_kernel(True, 1 << 21) == "block"
    assert choose_sweep_kernel(True, (1 << 21) + 1) == "cell"
    assert choose_sweep_kernel(False, 1) == "cell"
    # io/casegen.py:dam_break_3d at dx = 0.0035 and 0.0034
    assert choose_sweep_kernel(True, 2027667) == "block"
    assert choose_sweep_kernel(True, 2215035) == "cell"


def _single_device_rule(block_sweep, capacity):
    """The one-device rule as ``core/driver.py`` had it before the rules met."""
    return "block" if block_sweep and capacity <= 1 << 21 else "cell"


def _sharded_rule(block_sweep, capacity, rows):
    """The sharded rule as ``parallel/mesh.py:shard_simulation`` had it."""
    return "block" if block_sweep and rows <= 1 << 21 and capacity <= 2 ** 24 else "cell"


@pytest.mark.parametrize("block_sweep,capacity,rows,expect", [
    (True, 1 << 21, None, "block"),
    (True, (1 << 21) + 1, None, "cell"),
    (False, 1, None, "cell"),
    (False, 1 << 21, None, "cell"),
    (True, 1 << 22, 1 << 21, "block"),          # slabs' window C + 2 * halo
    (True, 1 << 22, (1 << 21) + 1, "cell"),
    (False, 1 << 22, 1 << 20, "cell"),
    (True, 1 << 24, 1 << 20, "block"),
    (True, (1 << 24) + 1, 1 << 20, "cell"),
    (True, 1 << 21, 1 << 21, "block"),          # halo 0: the whole capacity
    (True, (1 << 21) + 1, (1 << 21) + 1, "cell"),
])
def test_sweep_kernel_rule_single_and_sharded(block_sweep, capacity, rows, expect):
    """The one ``choose_sweep_kernel`` gives what the two rules it replaced
    gave: on one device (``rows`` None) and sharded."""
    old = (_single_device_rule(block_sweep, capacity) if rows is None
           else _sharded_rule(block_sweep, capacity, rows))
    assert choose_sweep_kernel(block_sweep, capacity, rows) == old == expect
