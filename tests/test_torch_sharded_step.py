"""The sharded slice as a whole on the CPU, in f64: the tall water column of
tests/test_sharded.py:99-158 (thin in x, long in z, so that the slabs of the
sorted order are thicker than one stencil reach) on 4 slabs - thread ranks
with CPU tensors - through ``shard_simulation`` and its interval function.

* port sharded vs port single-device to t = 0.004 at ``rtol=1e-9,
  atol=1e-12`` by particle id, equal iteration counts, ``0 < max_halo <=
  halo``, with and without mDBC, through either sweep entry, and with the
  whole-array window (``halo = 0``);
* port sharded vs the JAX package's ``shard_simulation(..., make_mesh(4))`` on
  4 virtual CPU devices - its all-gather XLA path (``use_pallas=False``) and
  its cell-pair kernel in interpret mode on the halo - within
  the bands of tests/test_trajectory.py:64-70;
* ``shard_simulation``'s halo, padded capacity and kernel choice against the
  JAX package's on the same deck;
* every rank takes the same lazy-rebuild branch; the ``max_halo > halo``
  guard of the driver (``auto_retune=False``) and its retune to the JAX
  package's halo floor, the whole-array fallback and the no-progress guard;
  a JAX sharded state carried into the port and back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.core.step import make_interval_fn as j_make_interval_fn
from sphexample_tpu.parallel.mesh import make_mesh as j_make_mesh
from sphexample_tpu.parallel.mesh import shard_simulation as j_shard
from sphexample_tpu_torch.core.driver import _overflow_reason, gather_state
from sphexample_tpu_torch.core.step import _initial_dx_acc, sph_step
from sphexample_tpu_torch.parallel.mesh import (make_mesh, make_sharded_fn,
                                                make_sharded_interval_fn,
                                                shard_simulation)

torch.set_num_threads(1)
OFF = 0.0037   # off the map_floor half-integer boundary (test_trajectory.py:35-42)
N = 4
T_OUT = 0.004
T_MID = 0.002


def _tall(M, mdbc=False, block=True, use_pallas=None, **kw):
    """The tall 2D column of tests/test_sharded.py:_tall_column_setup for
    either package ``M`` (shifted by ``OFF``)."""
    const = M.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    dx, nx, nz = const.dx, 6, 220
    xs, zs = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    fluid = np.stack([xs.ravel() * dx, zs.ravel() * dx + dx], axis=-1)
    floor_x = np.arange(-3, nx + 3) * dx
    floor = np.stack([floor_x, np.zeros_like(floor_x)], axis=-1)
    wall_z = np.arange(0, nz + 6) * dx
    lw = np.stack([np.full_like(wall_z, -dx), wall_z], axis=-1)
    rw = np.stack([np.full_like(wall_z, nx * dx), wall_z], axis=-1)
    bound = np.concatenate([floor, lw, rw])
    pos = np.concatenate([bound, fluid]) + OFF
    nb, n = len(bound), len(bound) + len(fluid)
    ptype = np.concatenate([np.full(nb, 2), np.full(n - nb, 1)]).astype(np.int32)
    extra = {} if use_pallas is None else {"use_pallas": use_pallas}
    meta = M.SimulationMetaData(
        simulation_name="halo", save_location=".", dims=2, dtype="float64",
        simulation_time=0.02, output_times=0.005, block_size=32, grid_margin_cells=4,
        block_sweep=block, mdbc=M.MDBCMode.SIMPLE if mdbc else M.MDBCMode.NONE, **extra)
    ghost = ghostn = None
    if mdbc:
        ghostn = np.concatenate([np.tile([[0.0, dx]], (len(floor), 1)),
                                 np.tile([[dx, 0.0]], (len(lw), 1)),
                                 np.tile([[-dx, 0.0]], (len(rw), 1))])
        ghost = bound + OFF + ghostn
    sim = M.assemble_simulation(
        pos, np.full(n, const.rho0), ptype, np.ones(n, np.int32), np.arange(1, n + 1),
        meta, const, kern, M.ViscosityModel.ARTIFICIAL, M.DensityDiffusionModel.LINEAR,
        ghost_points=ghost, ghost_normals=ghostn, **kw)
    if use_pallas:
        sim.cfg = dataclasses.replace(sim.cfg, pallas_interpret=True)
        sim.interval_fn = j_make_interval_fn(sim.cfg)
    return sim


def _port(mdbc=False, block=True, capacity=None):
    return _tall(T, mdbc, block, device="cpu", capacity=capacity)


def _by_id(ids, a):
    ids = np.asarray(ids)
    live = ids > 0
    return np.asarray(a)[live][np.argsort(ids[live], kind="stable")]


def _fields(state, to_np, names=("position", "velocity", "density")):
    p = state.particles
    return {f: _by_id(to_np(p.id), to_np(getattr(p, f))) for f in names}


def _tnp(a):
    return a.numpy()


def _bands(fw, ref, t_fw, t_ref, f32_kernel=False):
    """tests/test_trajectory.py:64-70.  ``f32_kernel``: the JAX side ran its
    Pallas kernel, which sums in f32 whatever the state's dtype, so the two
    trajectories differ by f32 rounding of the sweep sums: the bands are those
    the JAX package holds its f32 kernels to (2e-5 relative,
    tests/test_pallas_block.py:68-93), on velocity relative to its largest
    value."""
    scale = float(np.abs(ref["position"]).max())
    if f32_kernel:
        vmax = float(np.abs(ref["velocity"]).max())
        assert t_fw == pytest.approx(t_ref, rel=1e-6)
        np.testing.assert_allclose(fw["position"], ref["position"], rtol=0,
                                   atol=1e-7 * scale)
        np.testing.assert_allclose(fw["velocity"], ref["velocity"], rtol=0,
                                   atol=2e-5 * vmax)
        np.testing.assert_allclose(fw["density"], ref["density"], rtol=2e-5, atol=0)
        return
    assert t_fw == pytest.approx(t_ref, rel=1e-12)
    np.testing.assert_allclose(fw["position"], ref["position"], rtol=1e-9,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(fw["velocity"], ref["velocity"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(fw["density"], ref["density"], rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("mdbc,block", [(False, True), (True, True), (False, False)])
def test_sharded_matches_single_device(mdbc, block):
    single = _port(mdbc, block)
    sharded = shard_simulation(_port(mdbc, block), make_mesh(N, "cpu"))
    cfg = sharded.cfg
    assert cfg.halo > 0 and cfg.ctx.is_sharded and cfg.ctx.num_devices == N
    assert cfg.sweep_kernel == ("block" if block else "cell") == single.cfg.sweep_kernel
    assert isinstance(sharded.state, tuple) and len(sharded.state) == N
    one = single.interval_fn(single.state, T_OUT)
    states = sharded.interval_fn(sharded.state, T_OUT)
    four = gather_state(states)
    assert int(four.iteration) == int(one.iteration) > 5
    assert float(four.total_time) == float(one.total_time)
    assert 0 < int(four.max_halo) <= cfg.halo
    assert int(four.grid_escapes) == 0 and _overflow_reason(cfg, states) is None
    # the scalars and cell_start are replicated, the rebuilds taken together
    for s in states:
        assert float(s.total_time) == float(four.total_time)
        assert int(s.max_halo) == int(four.max_halo) and s.rebuilds == one.rebuilds
        assert torch.equal(s.cell_start, four.cell_start)
    names = ("position", "velocity", "density", "pressure", "acceleration")
    a, b = _fields(one, _tnp, names), _fields(four, _tnp, names)
    for f in names:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)
    # chunk ids count global sorted rows
    assert int(four.particles.chunk_id.max()) == (four.particles.capacity - 1) // 32
    if mdbc:
        walls = _by_id(four.particles.id.numpy(), four.particles.ptype.numpy()) == 2
        assert np.abs(b["density"][walls] - 1000.0).max() > 1e-3   # mDBC fired


@pytest.mark.parametrize("mdbc", [False, True])
def test_whole_array_window_matches_single_device(mdbc):
    """``halo = 0`` (a floor above a slab, as a thin-slab deck gives): the
    replicated rebuild and the sweeps on the whole gathered array."""
    single = _port(mdbc)
    sharded = shard_simulation(_port(mdbc), make_mesh(N, "cpu"), min_halo=10 ** 6)
    assert sharded.cfg.halo == 0 and sharded.cfg.sweep_kernel == "block"
    one = single.interval_fn(single.state, 0.002)
    four = gather_state(sharded.interval_fn(sharded.state, 0.002))
    assert int(four.iteration) == int(one.iteration) > 2 and int(four.max_halo) == 0
    a, b = _fields(one, _tnp), _fields(four, _tnp)
    for f in a:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)


def test_every_rank_takes_the_same_rebuild_branch():
    """The lazy rebuild is a host ``if`` on ``dx_acc``: it comes from the
    ``pmax`` of stage 00 alone, so every rank holds the same value on every
    step and rebuilds on the same steps."""
    sharded = shard_simulation(_port(), make_mesh(N, "cpu"))
    p = sharded.state
    # a column falling fast enough to rebuild again within two dozen steps
    fast = tuple(s.replace(particles=s.particles.replace(
        velocity=torch.stack([torch.zeros_like(s.particles.density),
                              -8.0 * s.particles.motion_limiter], dim=1))) for s in p)

    def make(cfg):
        def fn(state):
            dx, trace = _initial_dx_acc(cfg, state), []
            for _ in range(24):
                before = state.rebuilds
                state, dx = sph_step(cfg, state, dx)
                trace.append((float(dx), state.rebuilds - before))
            return trace
        return fn

    traces = make_sharded_fn(sharded.cfg, sharded.mesh, make)[0](fast)
    assert all(t == traces[0] for t in traces)
    took = [t for _, t in traces[0]]
    assert took[0] == 1 and sum(took[1:]) >= 1 and took.count(0) > 10


@pytest.fixture(scope="module")
def jax_halo_run():
    """The JAX package on 4 virtual devices, its cell-pair kernel in interpret
    mode on the 1-hop halo: the sharded simulation, its state at t = 0.002
    and, stepped on from there, at t = 0.004 (one run for two tests: compiling
    the interpreted kernel under ``shard_map`` takes most of the time)."""
    single_j = _tall(J, block=False, use_pallas=True)
    sim_j = j_shard(single_j, j_make_mesh(N))
    assert sim_j.cfg.halo > 0
    # the interval function returns its (empty, with the cell-pair kernel)
    # block tables replicated: hand them in so, and the second call reuses
    # the first one's compilation
    mesh = sim_j.state.particles.id.sharding.mesh
    start = sim_j.state.replace(block_tables=jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, PartitionSpec())),
        sim_j.state.block_tables))
    mid = sim_j.interval_fn(start, jnp.asarray(T_MID, dtype=jnp.float64))
    end = sim_j.interval_fn(mid, jnp.asarray(T_OUT, dtype=jnp.float64))
    return sim_j, single_j.state.particles.capacity, mid, end


def _against_jax(ft, fj, f32_kernel):
    assert int(ft.iteration) == int(fj.iteration)
    _bands(_fields(ft, _tnp), _fields(fj, np.asarray), float(ft.total_time),
           float(fj.total_time), f32_kernel=f32_kernel)
    np.testing.assert_array_equal(ft.cell_start.numpy(), np.asarray(fj.cell_start))


@pytest.mark.parametrize("mdbc", [False, True])
def test_sharded_matches_jax_all_gather(mdbc):
    """The port on 4 slabs against the JAX package on 4 virtual devices, its
    all-gather XLA path (``use_pallas=False``): the trajectory bands."""
    single_j = _tall(J, mdbc, block=False, use_pallas=False)
    sim_j = j_shard(single_j, j_make_mesh(N))
    assert sim_j.cfg.halo == 0
    fj = sim_j.interval_fn(sim_j.state, jnp.asarray(T_OUT, dtype=jnp.float64))
    sharded = shard_simulation(
        _port(mdbc, block=False, capacity=single_j.state.particles.capacity),
        make_mesh(N, "cpu"))
    _against_jax(gather_state(sharded.interval_fn(sharded.state, T_OUT)), fj, False)


def test_sharded_matches_jax_halo_kernel(jax_halo_run):
    """... and against its cell-pair kernel on the 1-hop halo, both runs two
    intervals from the start; the halo telemetry agrees to the row."""
    sim_j, cap, _, fj = jax_halo_run
    sharded = shard_simulation(_port(block=False, capacity=cap), make_mesh(N, "cpu"))
    assert sharded.cfg.halo == sim_j.cfg.halo
    states = sharded.interval_fn(sharded.state, T_MID)
    ft = gather_state(sharded.interval_fn(states, T_OUT))
    _against_jax(ft, fj, True)
    assert int(ft.max_halo) == int(fj.max_halo) > 0


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("mdbc", [False, True])
def test_shard_simulation_sizes_like_jax(block, mdbc):
    single_j = _tall(J, mdbc, block, use_pallas=True)
    sim_j = j_shard(single_j, j_make_mesh(N))
    # the same deck: the JAX package rounds the capacity up when it assembles
    sharded = shard_simulation(
        _port(mdbc, block, capacity=single_j.state.particles.capacity),
        make_mesh(N, "cpu"))
    assert sharded.cfg.halo == sim_j.cfg.halo > 0
    cap = sum(s.particles.capacity for s in sharded.state)
    assert cap == sim_j.state.particles.capacity and cap % (N * 512) == 0
    assert (sharded.cfg.sweep_kernel == "block") == (sim_j.cfg.ct_cap > 0) == block
    # the pre-sort gives the JAX package's slabs
    got = torch.cat([s.particles.id for s in sharded.state]).numpy()
    np.testing.assert_array_equal(got, np.asarray(sim_j.state.particles.id))
    np.testing.assert_array_equal(sharded.state[0].cell_start.numpy(),
                                  np.asarray(sim_j.state.cell_start))
    assert sharded.n_live == sim_j.n_live == int(sum(s.particles.active.sum()
                                                      for s in sharded.state))


def test_shard_simulation_resets_telemetry_and_rejects_a_second_cut():
    sim = _port()
    sim.state = sim.state.replace(max_halo=torch.tensor(10 ** 6, dtype=torch.int32),
                                  grid_escapes=torch.tensor(7, dtype=torch.int32))
    sharded = shard_simulation(sim, make_mesh(N, "cpu"))
    assert all(int(s.max_halo) == 0 and int(s.grid_escapes) == 0 for s in sharded.state)
    with pytest.raises(ValueError, match="already sharded"):
        shard_simulation(sharded, make_mesh(N, "cpu"))
    with pytest.raises(ValueError, match="slab states"):
        sharded.interval_fn(sharded.state[:2], T_OUT)


def test_halo_guard_raises():
    """A halo below the windows' reach: the step reports the reach in
    ``max_halo`` and the driver refuses the interval."""
    sharded = shard_simulation(_port(), make_mesh(N, "cpu"))
    small = dataclasses.replace(sharded.cfg, halo=8)
    sharded.interval_fn, sharded.cfg = make_sharded_interval_fn(small, sharded.mesh)
    with pytest.raises(RuntimeError, match="halo capacity 8"):
        T.run_simulation(sharded, max_intervals=1, auto_retune=False)
    # within the halo the same driver loop runs the intervals and logs them
    ok = shard_simulation(_port(), make_mesh(N, "cpu"))
    ok.meta = T.replace(ok.meta, output_times=0.001, simulation_time=0.0015)
    logs = []
    T.run_simulation(ok, log_callback=logs.append)
    assert len(logs) == 2 and logs[-1]["total_time"] > 0.0015
    assert isinstance(ok.state, tuple) and int(ok.state[0].iteration) == logs[-1]["iteration"]


def test_halo_floor_is_the_jax_expression():
    """``parallel.mesh.halo_floor`` against the JAX sharded retune's own
    ``min_halo`` line (sphexample_tpu/core/driver.py:373), evaluated on the
    same inputs."""
    import inspect

    from sphexample_tpu.core import driver as jd
    from sphexample_tpu_torch.parallel.mesh import halo_floor

    line = next(ln.strip() for ln in inspect.getsource(jd._retune).splitlines()
                if ln.strip().startswith("min_halo = "))
    expr = compile(line.split("=", 1)[1].strip(), "driver.py", "eval")
    for need in (0, 1, 50, 63, 64, 65, 127, 128, 1000, 15596):
        for halo in (0, 8, 128, 256, 512, 31360):
            cfg = dataclasses.make_dataclass("Cfg", ["halo"])(halo)
            assert halo_floor(need, halo) == eval(expr, {"halo_need": need, "cfg": cfg}), \
                (need, halo)


def _cut_halo(sharded, halo):
    small = dataclasses.replace(sharded.cfg, halo=halo)
    sharded.interval_fn, sharded.cfg = make_sharded_interval_fn(small, sharded.mesh)
    return sharded


def test_halo_overrun_retunes_to_the_jax_floor_and_replays():
    """A halo of 8 rows on the tall column: the interval overruns it, the
    driver re-shards with a halo of at least ``halo_floor(max_halo, 8)`` and
    replays the interval, which then ends where the single-device run ends."""
    from sphexample_tpu_torch.parallel.mesh import halo_floor

    sharded = _cut_halo(shard_simulation(_port(), make_mesh(N, "cpu")), 8)
    first, needs = sharded.interval_fn, []

    def spy(states, t_out, progress=None):
        states = first(states, t_out, progress)
        needs.append(int(states[0].max_halo))
        return states

    sharded.interval_fn = spy
    T.run_simulation(sharded, max_intervals=1)
    C = sharded.state[0].particles.capacity
    assert len(needs) == 1 and needs[0] > 8
    assert C >= sharded.cfg.halo >= halo_floor(needs[0], 8)
    assert sharded.hourglass.counts["02b Retune neighbor windows"] == 1
    end = gather_state(sharded.state)
    assert 0 < int(end.max_halo) <= sharded.cfg.halo and int(end.grid_escapes) == 0
    single = _port()
    one = single.interval_fn(single.state, sharded.meta.output_time_for(1))
    assert int(end.iteration) == int(one.iteration)
    a, b = _fields(one, _tnp), _fields(end, _tnp)
    for f in a:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)


def test_a_floor_above_a_slab_falls_back_to_the_whole_array():
    """A retune whose floor exceeds a slab re-shards with ``halo = 0`` (the
    whole gathered array, which cannot overflow), and the replay completes;
    one that changes neither the grid nor the halo raises."""
    from sphexample_tpu_torch.core import driver as td

    sharded = shard_simulation(_port(), make_mesh(N, "cpu"))
    C = sharded.state[0].particles.capacity
    failed = tuple(s.replace(max_halo=torch.tensor(C, dtype=torch.int32))
                   for s in sharded.state)
    new, states = td._retune(sharded, sharded.state, failed)
    assert sharded.cfg.halo > 0 and new.cfg.halo == 0 and new.mesh == sharded.mesh
    out = new.interval_fn(states, T_OUT)
    assert _overflow_reason(new.cfg, out) is None
    single = _port()
    a, b = _fields(single.interval_fn(single.state, T_OUT), _tnp), _fields(
        gather_state(out), _tnp)
    for f in a:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)
    with pytest.raises(RuntimeError, match="made no progress"):
        td._retune(new, states, failed)


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


def test_jax_sharded_state_carries_into_the_port_and_back(jax_halo_run):
    """A JAX sharded state (halo path, cell-pair kernel in interpret mode) an
    interval in: its global arrays become the port's 4 slab states, go back
    bit for bit, and the next interval agrees on both sides."""
    sim_j, cap, sj, fj = jax_halo_run
    leaves = _leaves(sj)
    sharded = shard_simulation(_port(block=False, capacity=cap), make_mesh(N, "cpu"))
    assert sharded.cfg.halo == sim_j.cfg.halo
    states = T.state_from_numpy(leaves, "cpu", devices=sharded.mesh.devices)
    assert len(states) == N and states[1].particles.capacity * N == len(
        leaves["particles.id"])
    assert int(states[2].max_halo) == int(sj.max_halo) > 0
    back = T.state_to_numpy(states)
    for k, v in back.items():
        assert v.dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)
    ft = gather_state(sharded.interval_fn(states, T_OUT))
    _against_jax(ft, fj, True)
