"""The port's host loop on the CPU against the JAX package's: re-grid and
replay on a grid escape (the setup of tests/test_aux.py:477-541: 200
particles in f64, one launched at 30 m/s through the grid's 2-cell margin),
``run_simulation``'s callbacks and sections, the chunked interval, the
asynchronous saver, the watchdog, and on 4 slabs the
sharded retune (a constructed escape re-gridded, re-sharded and replayed,
against the JAX package's sharded retune on 4 virtual devices) and, with
``auto_retune=False``, the refusal of an escape."""

import dataclasses
import hashlib
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.core import driver as jd
from sphexample_tpu_torch.core import driver as td
from sphexample_tpu_torch.core.step import make_interval_fn
from sphexample_tpu_torch.io.checkpoint import save_checkpoint
from sphexample_tpu_torch.ops.cell_list import Grid
from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation
from sphexample_tpu_torch.state import state_tensors
from sphexample_tpu_torch.utils.timers import HourGlass
from sphexample_tpu_torch.utils.watchdog import DeviceWatchdog

torch.set_num_threads(1)
N = 200


def _escape_sim(M, save_location=".", **kw):
    """tests/test_aux.py:477-541 for either package ``M``: a random blob,
    then particle 1 moved to (0.45, 0.15) and launched at 30 m/s in +x after
    assembly (the grid is sized from the blob)."""
    rng = np.random.default_rng(7)
    const = M.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    pos = rng.uniform(0, 0.3, size=(N, 2))
    meta = M.SimulationMetaData(
        simulation_name="esc", save_location=save_location, dims=2,
        simulation_time=0.02, output_times=0.01, block_size=64,
        dtype="float64", grid_margin_cells=2,
    )
    sim = M.assemble_simulation(
        pos, np.full(N, const.rho0), np.ones(N, np.int32), np.ones(N, np.int32),
        np.arange(1, N + 1), meta, const, kern, M.ViscosityModel.ARTIFICIAL,
        M.DensityDiffusionModel.ZERO, **kw,
    )
    p = sim.state.particles
    vel = np.zeros((p.capacity, 2))
    vel[0, 0] = 30.0
    pos2 = np.asarray(p.position).copy()
    pos2[0] = [0.45, 0.15]
    if M is J:
        p = p.replace(velocity=jnp.asarray(vel), position=jnp.asarray(pos2))
    else:
        p = p.replace(velocity=torch.as_tensor(vel), position=torch.as_tensor(pos2))
    sim.state = sim.state.replace(particles=p)
    return sim


def _port_escape(**meta_kw):
    sim = _escape_sim(T, device="cpu")
    if meta_kw:
        sim.meta = T.replace(sim.meta, **meta_kw)
        sim.cfg = dataclasses.replace(sim.cfg, meta=sim.meta)
        sim.interval_fn = make_interval_fn(sim.cfg)
    return sim


def _digest(state) -> str:
    """SHA-256 over every tensor of a state (and the host rebuild count)."""
    h = hashlib.sha256(str(state.rebuilds).encode())
    for k, v in state_tensors(state).items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _by_id(ids, a):
    ids = np.asarray(ids)
    live = ids > 0
    return np.asarray(a)[live][np.argsort(ids[live], kind="stable")]


def _end(state):
    p = state.particles
    return {f: _by_id(p.id, getattr(p, f)) for f in ("position", "velocity", "density")}


def _jax_leaves(state):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "particles":
            out.update({f"particles.{g.name}": np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
    return out


def _run(M, sim, **kw):
    saved, logs = [], []
    M.run_simulation(sim, save_callback=lambda c, s: saved.append(c),
                     log_callback=logs.append, max_intervals=2, **kw)
    return sim, saved, logs


@pytest.fixture(scope="module")
def runs():
    """The escape run in both packages, with their save and log records, and
    the port's pre-interval state's digest."""
    sim_t = _port_escape()
    start = sim_t.state
    before = _digest(start)
    return _run(J, _escape_sim(J)), _run(T, sim_t), start, before


def test_regrow_grid_matches_jax_on_the_same_state():
    sim_j = _escape_sim(J)
    failed_j = sim_j.interval_fn(sim_j.state, jnp.asarray(0.01, dtype=jnp.float64))
    assert int(failed_j.grid_escapes) == 1
    failed_t = T.state_from_numpy(_jax_leaves(failed_j), "cpu")
    sim_t = _port_escape()
    assert sim_t.cfg.grid == Grid(sim_j.cfg.grid.cmin, sim_j.cfg.grid.shape)
    gj = jd._regrow_grid(sim_j.cfg, failed_j, 2)
    gt = td._regrow_grid(sim_t.cfg, failed_t, 2)
    assert (gt.cmin, gt.shape) == (gj.cmin, gj.shape)
    assert gt.ncells > sim_t.cfg.grid.ncells
    # and on the port's own failed interval
    failed_own = sim_t.interval_fn(sim_t.state, 0.01)
    own = td._regrow_grid(sim_t.cfg, failed_own, 2)
    assert (own.cmin, own.shape) == (gj.cmin, gj.shape)


def test_run_simulation_regrids_and_matches_jax(runs):
    (sim_j, _, _), (sim_t, _, _), _, _ = runs
    assert sim_t.cfg.grid.ncells > _port_escape().cfg.grid.ncells
    assert (sim_t.cfg.grid.cmin, sim_t.cfg.grid.shape) == (sim_j.cfg.grid.cmin,
                                                           sim_j.cfg.grid.shape)
    assert int(sim_t.state.grid_escapes) == 0
    assert sim_t.hourglass.counts["02b Retune neighbor windows"] == \
        sim_j.hourglass.counts["02b Retune neighbor windows"] == 2
    assert set(sim_t.hourglass.counts) == set(sim_j.hourglass.counts)
    # every live particle inside the grown grid
    pos = sim_t.state.particles.position.numpy()[sim_t.state.particles.active.numpy()]
    c = np.sign(pos) * np.trunc(np.abs(pos) * sim_t.cfg.spec.kernel.H_inv + 0.5)
    lo = np.asarray(sim_t.cfg.grid.cmin)
    assert ((c >= lo) & (c <= lo + np.asarray(sim_t.cfg.grid.shape) - 1)).all()
    # the end states by particle id, within tests/test_trajectory.py:64-70
    ft, fj = _end(sim_t.state), _end(sim_j.state)
    assert float(sim_t.state.total_time) == pytest.approx(float(sim_j.state.total_time),
                                                          rel=1e-12)
    assert float(sim_t.state.current_dt) == pytest.approx(float(sim_j.state.current_dt),
                                                          rel=1e-12)
    scale = float(np.abs(fj["position"]).max())
    np.testing.assert_allclose(ft["position"], fj["position"], rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(ft["velocity"], fj["velocity"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(ft["density"], fj["density"], rtol=1e-9, atol=1e-6)


def test_callbacks_match_jax(runs):
    (_, saved_j, logs_j), (_, saved_t, logs_t), _, _ = runs
    assert saved_t == saved_j == [1, 2, 3]
    assert [sorted(d) for d in logs_t] == [sorted(d) for d in logs_j]
    for key in ("counter", "iteration", "steps_in_interval"):
        assert [d[key] for d in logs_t] == [d[key] for d in logs_j]
    for key in ("total_time", "dt"):
        np.testing.assert_allclose([d[key] for d in logs_t], [d[key] for d in logs_j],
                                   rtol=1e-12)


def test_the_pre_interval_state_is_not_written(runs):
    """The replay and the saver rely on it: nothing writes in place into a
    state the loop has handed on."""
    _, _, start, before = runs
    assert _digest(start) == before
    sim = _port_escape()
    first = sim.state
    d0 = _digest(first)
    with pytest.raises(RuntimeError, match="escaped"):
        T.run_simulation(sim, max_intervals=2, auto_retune=False)
    assert _digest(first) == d0 and sim.state is first


def test_auto_retune_off_raises_like_jax():
    with pytest.raises(RuntimeError, match="escaped") as ej:
        J.run_simulation(_escape_sim(J), max_intervals=2, auto_retune=False)
    with pytest.raises(RuntimeError, match="escaped") as et:
        T.run_simulation(_port_escape(), max_intervals=2, auto_retune=False)
    assert str(et.value) == str(ej.value)


def test_regrow_refuses_diverged_and_runaway_states():
    sim = _port_escape()
    p = sim.state.particles
    pos = p.position.clone()
    pos[3, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        td._regrow_grid(sim.cfg, sim.state.replace(particles=p.replace(position=pos)), 2)
    pos = p.position.clone()
    pos[3] = torch.tensor([400.0, -300.0], dtype=pos.dtype)
    with pytest.raises(RuntimeError, match="far outside"):
        td._regrow_grid(sim.cfg, sim.state.replace(particles=p.replace(position=pos)), 2)
    # an inactive row is not looked at
    pos[3, 1] = float("nan")
    act = p.active.clone()
    act[3] = False
    grid = td._regrow_grid(sim.cfg, sim.state.replace(
        particles=p.replace(position=pos, active=act)), 2)
    assert grid.ncells >= sim.cfg.grid.ncells


def test_retune_without_an_escape_made_no_progress():
    sim = _port_escape()
    with pytest.raises(RuntimeError, match="retune made no progress"):
        td._retune(sim, sim.state, sim.state)


def tiny(M, save_location=".", capacity=None, **meta_kw):
    """The 8 x 8 fluid block over a floor of tests/test_aux.py:402-427 for
    either package ``M`` (f64; the port on the CPU).  Shared by the port's
    host-loop test files."""
    const = M.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    dx = const.dx
    xs, zs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    fluid = np.stack([xs.ravel() * dx, zs.ravel() * dx + dx], axis=-1)
    floor_x = np.arange(-3, 11) * dx
    floor = np.stack([floor_x, np.zeros_like(floor_x)], axis=-1)
    pos = np.concatenate([floor, fluid])
    ptype = np.concatenate([np.full(len(floor), 2), np.full(len(fluid), 1)]).astype(np.int32)
    meta = M.SimulationMetaData(
        simulation_name="Tiny", save_location=str(save_location), dims=2,
        dtype="float64", simulation_time=0.01, output_times=0.002,
        grid_margin_cells=4, **meta_kw)
    extra = {"device": "cpu"} if M is T else {}
    return M.assemble_simulation(
        pos, np.full(len(pos), const.rho0), ptype, np.ones(len(pos), np.int32),
        np.arange(1, len(pos) + 1), meta, const, kern, M.ViscosityModel.ARTIFICIAL,
        M.DensityDiffusionModel.LINEAR, capacity=capacity, **extra)


def _tiny_port(**meta_kw):
    return tiny(T, **meta_kw)


def test_chunked_interval_is_the_unchunked_one_bit_for_bit():
    whole = _tiny_port(max_steps_per_call=None)
    chunked = _tiny_port(max_steps_per_call=3)
    a = whole.interval_fn(whole.state, 0.004)
    seen = []
    b = chunked.interval_fn(chunked.state, 0.004, lambda s: seen.append(int(s.iteration)))
    assert _digest(a) == _digest(b)
    steps = int(b.iteration)
    assert steps > 6
    # progress after every chunk but the last
    assert seen == [3 * k for k in range(1, -(-steps // 3))]
    # sharded: every rank runs the chunks, rank 0 alone reports progress
    sharded = shard_simulation(_tiny_port(max_steps_per_call=3, block_size=32),
                               make_mesh(2, "cpu"))
    seen_sh = []
    states = sharded.interval_fn(sharded.state, 0.004,
                                 lambda s: seen_sh.append(int(s.iteration)))
    assert seen_sh == seen and int(states[1].iteration) == steps


def test_async_saver_ordering_and_errors():
    """tests/test_aux.py:344 for the port: one worker keeps the order; a
    worker's exception surfaces on the next put and on close()."""
    seen = []

    def cb(counter, state):
        time.sleep(0.01)
        seen.append(counter)

    s = td._AsyncSaver(cb)
    for c in range(1, 8):
        s(c, None)
    s.close()
    assert seen == list(range(1, 8))

    def boom(counter, state):
        raise ValueError("disk full")

    s2 = td._AsyncSaver(boom)
    s2(1, None)
    with pytest.raises(RuntimeError, match="async save failed"):
        s2.close()
    s3 = td._AsyncSaver(boom)
    s3(1, None)
    s3._t.join(timeout=10)
    assert not s3._t.is_alive()
    with pytest.raises(RuntimeError, match="async save failed"):
        s3(2, None)
    with pytest.raises(RuntimeError, match="async save failed"):
        s3.drain()


def test_async_saver_drain_waits_for_a_slow_worker():
    seen = []
    s = td._AsyncSaver(lambda c, st: (time.sleep(0.05), seen.append(c)))
    s(1, None)
    s(2, None)
    s.drain()
    assert seen == [1, 2]
    s.close()


def test_async_snapshots_are_the_states_the_loop_held(tmp_path):
    """The checkpoints written on the worker thread equal, bit for bit, the
    states a synchronous run hands its callback at each counter; and a slow
    worker still records, for each snapshot, the grid it was stepped on
    across the re-grids (run_simulation drains the saver first)."""
    records = {}
    for mode in (True, False):
        sim = _port_escape(async_output=mode)
        rec = records[mode] = []

        def save(counter, state, sim=sim, rec=rec):
            if mode:
                time.sleep(1.0)  # slower than an interval of this deck
            path = str(tmp_path / f"{mode}_{counter}.npz")
            save_checkpoint(path, state, counter, grid=sim.cfg.grid)
            rec.append((counter, _digest(state), state.cell_start.numel(),
                        sim.cfg.grid.ncells + 2))

        T.run_simulation(sim, save_callback=save, max_intervals=2)
        assert [r[0] for r in rec] == [1, 2, 3]
        assert all(r[2] == r[3] for r in rec)
    assert records[True] == records[False]


def test_device_watchdog_fires_and_disarms():
    """tests/test_aux.py:605 for the port's copy."""
    wd = DeviceWatchdog(timeout=0.15, hard=False, poll=0.05)
    try:
        time.sleep(0.3)
        assert not wd.fired
        wd.arm("test block")
        time.sleep(0.4)
        assert wd.fired
        wd.disarm()
    finally:
        wd.stop()


def test_interval_with_watchdog_runs_green():
    """tests/test_aux.py:626: the watchdog wiring does not perturb a
    healthy run, and the watchdog thread is stopped afterwards."""
    plain = _tiny_port(max_steps_per_call=4)
    watched = _tiny_port(max_steps_per_call=4, device_call_timeout=300.0)
    before = {t.name for t in threading.enumerate()}
    out = watched.interval_fn(watched.state, 0.004)
    out = watched.interval_fn(out, 0.006)  # warm: armed around every chunk
    ref = plain.interval_fn(plain.interval_fn(plain.state, 0.004), 0.006)
    assert _digest(out) == _digest(ref)
    assert {t.name for t in threading.enumerate()} <= before


def test_hourglass_sections_and_report():
    hg = HourGlass()
    with hg.section("00 SimulationLoop"):
        time.sleep(0.01)
    with hg.section("00 SimulationLoop"):
        pass
    with hg.section("13 Save Particle Data"):
        pass
    assert hg.counts == {"00 SimulationLoop": 2, "13 Save Particle Data": 1}
    assert hg.totals["00 SimulationLoop"] >= 0.01
    rep = hg.report()
    assert re.search(r"00 SimulationLoop\s+2", rep) and "wall clock" in rep


def test_sharded_run_raises_on_an_escape_with_the_jax_message():
    sim_j = _escape_sim(J)
    failed_j = sim_j.interval_fn(sim_j.state, jnp.asarray(0.01, dtype=jnp.float64))
    want = jd._overflow_reason(sim_j.cfg, failed_j)
    sharded = shard_simulation(_port_escape(), make_mesh(4, "cpu"))
    with pytest.raises(RuntimeError) as e:
        T.run_simulation(sharded, max_intervals=1, auto_retune=False)
    assert str(e.value) == want
    assert isinstance(sharded.state, tuple)


# --- the sharded retune: re-grid, re-shard and replay on 4 slabs -------------------

def _tall_escape(M):
    """The tall column of tests/test_torch_sharded_step.py (f64; the JAX
    package on its all-gather XLA path) with its highest fluid particle moved
    1.5 cells below the grid's top edge and launched at 30 m/s in +z: it
    leaves the grid within the first output interval."""
    from test_torch_sharded_step import _tall

    sim = _tall(J, use_pallas=False) if M is J else _tall(T, device="cpu")
    p, g = sim.state.particles, sim.cfg.grid
    pos = np.asarray(p.position).copy()
    vel = np.zeros_like(pos)
    i = int(np.argmax(np.where(np.asarray(p.ptype) == 1, pos[:, 1], -np.inf)))
    pos[i, 1] = (g.cmin[1] + g.shape[1] - 1.5) * sim.cfg.spec.kernel.H
    vel[i, 1] = 30.0
    conv = jnp.asarray if M is J else torch.as_tensor
    sim.state = sim.state.replace(particles=p.replace(position=conv(pos),
                                                      velocity=conv(vel)))
    return sim


@pytest.fixture(scope="module")
def sharded_escape():
    """The escape on 4 slabs through both packages' ``run_simulation`` (JAX
    on 4 virtual devices), the port with a save callback that records the
    grid of each snapshot, and the port's pre-interval slabs' digests."""
    from sphexample_tpu.parallel.mesh import make_mesh as j_mesh
    from sphexample_tpu.parallel.mesh import shard_simulation as j_shard

    sim_j = J.run_simulation(j_shard(_tall_escape(J), j_mesh(4)), max_intervals=1)
    sim_t = shard_simulation(_tall_escape(T), make_mesh(4, "cpu"))
    start, grid0, halo0, mesh0 = sim_t.state, sim_t.cfg.grid, sim_t.cfg.halo, sim_t.mesh
    before = [_digest(s) for s in start]
    saved = []
    T.run_simulation(sim_t, max_intervals=1, save_callback=lambda c, s: saved.append(
        (c, sim_t.cfg.grid, len(s))))
    return sim_j, sim_t, start, before, (grid0, halo0, mesh0), saved


def test_sharded_escape_regrids_reshards_and_matches_jax(sharded_escape):
    sim_j, sim_t, _, _, (grid0, halo0, mesh0), _ = sharded_escape
    grid = sim_t.cfg.grid
    assert (grid.cmin, grid.shape) == (sim_j.cfg.grid.cmin, sim_j.cfg.grid.shape)
    assert grid.ncells > grid0.ncells
    assert sim_t.cfg.ctx.is_sharded and isinstance(sim_t.state, tuple)
    assert len(sim_t.state) == 4 and sim_t.mesh == mesh0
    # the halo floor of JAX's sharded retune: at least the old halo + 128
    assert sim_t.cfg.halo >= halo0 + 128 and halo0 > 0
    assert sim_t.hourglass.counts["02b Retune neighbor windows"] == \
        sim_j.hourglass.counts["02b Retune neighbor windows"] == 1
    end = td.gather_state(sim_t.state)
    assert int(end.grid_escapes) == 0 and 0 < int(end.max_halo) <= sim_t.cfg.halo
    assert int(end.iteration) == int(sim_j.state.iteration)
    assert float(end.total_time) == pytest.approx(float(sim_j.state.total_time), rel=1e-12)
    ft, fj = _end(end), _end(sim_j.state)
    scale = float(np.abs(fj["position"]).max())
    np.testing.assert_allclose(ft["position"], fj["position"], rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(ft["velocity"], fj["velocity"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(ft["density"], fj["density"], rtol=1e-9, atol=1e-6)


def test_sharded_retune_leaves_the_pre_interval_slabs(sharded_escape):
    """The failed interval and the re-shard write into no slab of the
    pre-interval state; each snapshot is saved with the grid it was stepped
    on (the saver is drained before the re-grid)."""
    _, sim_t, start, before, (grid0, _, _), saved = sharded_escape
    assert [_digest(s) for s in start] == before
    assert saved == [(1, grid0, 4), (2, sim_t.cfg.grid, 4)]


def test_sharded_escape_ends_where_the_single_device_retune_ends(sharded_escape):
    _, sim_t, _, _, _, _ = sharded_escape
    single = _tall_escape(T)
    T.run_simulation(single, max_intervals=1)
    assert single.cfg.grid == sim_t.cfg.grid
    end = td.gather_state(sim_t.state)
    assert int(end.iteration) == int(single.state.iteration)
    a, b = _end(single.state), _end(end)
    for f in a:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-9, atol=1e-12, err_msg=f)
