"""A chunk of steps as one device program (``core/step.py:make_chunk_body``,
``make_chunk_loop``), on the CPU: the port's chunk against the JAX package's
``make_chunk_body`` and ``make_interval_fn`` on the same seeded states in
f64, stage 02's helper against the JAX step's rebuild and no-rebuild
branches, the decisions in the state's dtype on a constructed tie (JAX's
answers), the chunk's buffers kept apart from every state it hands in or
out, a sharded config's route by where its slabs lie, and an old
checkpoint's ``int`` rebuild count.  On the card the chunk is a CUDA graph
(``tests/test_torch_cuda.py``); here the same guarded steps run eagerly on
the same buffers.  Tolerances: tests/test_sweep.py:103-107."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.core.step import make_chunk_body as j_chunk_body
from sphexample_tpu.core.step import make_interval_fn as j_interval_fn
from sphexample_tpu.core.step import sph_step as j_step
from sphexample_tpu_torch.core import step as S
from sphexample_tpu_torch.io.casegen import dam_break_3d
from sphexample_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation
from sphexample_tpu_torch.state import state_leaves
from test_torch_step import _assemble_port, _by_id, _square, _started_pair, _wedge

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-8   # tests/test_sweep.py:103-107


def _fields(ids, p, to_np):
    return {f: _by_id(ids, to_np(getattr(p, f)))
            for f in ("position", "velocity", "density")}


def _agree(st, sj):
    """The port's state ``st`` against the JAX state ``sj``: the same step
    count and sorted order, the fields within the tolerances."""
    assert int(st.iteration) == int(sj.iteration)
    np.testing.assert_array_equal(st.particles.id.numpy(), np.asarray(sj.particles.id))
    np.testing.assert_array_equal(st.cell_start.numpy(), np.asarray(sj.cell_start))
    a = _fields(st.particles.id.numpy(), st.particles, lambda t: t.numpy())
    b = _fields(np.asarray(sj.particles.id), sj.particles, np.asarray)
    for f in a:
        np.testing.assert_allclose(a[f], b[f], rtol=RTOL, atol=ATOL, err_msg=f)
    assert float(st.total_time) == pytest.approx(float(sj.total_time), rel=RTOL)


@pytest.fixture(scope="module")
def falling():
    """A falling column 5 steps in (JAX state and the port's copy) and an
    output time between its steps 13 and 14 from there (the port's eager
    steps find it): 14 steps, which end inside a chunk of 3."""
    sim_j, sj, sim_t, st = _started_pair(fluid_vz=-12.0)
    s, dx, times = st, S._initial_dx_acc(sim_t.cfg, st), []
    for _ in range(14):
        s, dx = S.sph_step(sim_t.cfg, s, dx)
        times.append(float(s.total_time))
    return sim_j, sj, sim_t, st, 0.5 * (times[12] + times[13])


@pytest.mark.parametrize("cap", [3, None])
def test_chunk_body_matches_jax(cap, falling):
    """The port's chunk against JAX ``make_chunk_body`` on a falling column
    (a rebuild every few steps), chunk by chunk to an output time crossed
    inside a chunk: the same steps, the same accumulator, the same fields.
    With ``max_steps_per_call=None`` the JAX chunk is one unbounded loop and
    the port's replays its bounded chunk until the time is crossed."""
    sim_j, sj, sim_t, st, t_out = falling
    meta = T.replace(sim_t.meta, max_steps_per_call=cap)
    cfg_t = dataclasses.replace(sim_t.cfg, meta=meta)
    cfg_j = dataclasses.replace(sim_j.cfg, meta=J.replace(sim_j.cfg.meta,
                                                          max_steps_per_call=cap))
    chunk_t, chunk_j = S.make_chunk_body(cfg_t), jax.jit(j_chunk_body(cfg_j))
    h = sim_t.cfg.spec.kernel.h
    dj = jnp.asarray(1.0 + h)
    dx = torch.tensor(1.0 + h, dtype=torch.float64)
    it0, r0 = int(st.iteration), int(st.rebuilds)
    chunks = 0
    while float(sj.total_time) <= t_out:
        sj, dj = chunk_j(sj, jnp.asarray(t_out), dj)
        chunks += 1
    done = 0
    while float(st.total_time) <= t_out:
        st, dx = chunk_t(st, t_out, dx)
        done += 1
    _agree(st, sj)
    assert float(dx) == pytest.approx(float(dj), rel=RTOL, abs=1e-15)
    steps = int(st.iteration) - it0
    assert float(st.total_time) > t_out and steps == 14
    if cap:
        assert chunks == done == -(-steps // cap) and steps % cap != 0
    else:
        assert chunks == done == 1
    assert int(st.rebuilds) - r0 >= 2      # the interval's first step, and later


@pytest.mark.parametrize("rebuild", [False, True])
def test_stage02_helper_matches_jax_branches(rebuild, falling):
    """``_lazy_rebuild`` for both flag values: eager (a host ``if``) against
    what the JAX step's ``do_rebuild`` / ``no_rebuild`` hand on (the sorted
    order, ``cell_start``, the telemetry, the accumulator), and inside a
    chunk (the rebuild written in place into the tensors the no-rebuild
    branch hands on) bit for bit the eager result."""
    sim_j, sj, sim_t, st, _ = falling
    cfg = sim_t.cfg
    h = cfg.spec.kernel.h
    dx0 = 1.0 + h if rebuild else 0.0
    nj, dj = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))(sj, jnp.asarray(dx0))
    # the accumulator as stage 00 hands it to stage 02
    disp2 = torch.sum((st.position_half - st.particles.position) ** 2, dim=-1)
    dx = dx0 + 4.0 * torch.sqrt(torch.max(disp2))
    eager = S._lazy_rebuild(cfg, st, st.particles, dx)
    assert (eager.particles is st.particles) is not rebuild
    np.testing.assert_array_equal(eager.particles.id.numpy(), np.asarray(nj.particles.id))
    np.testing.assert_array_equal(eager.particles.cell.numpy(), np.asarray(nj.particles.cell))
    np.testing.assert_array_equal(eager.particles.chunk_id.numpy(),
                                  np.asarray(nj.particles.chunk_id))
    np.testing.assert_array_equal(eager.cell_start.numpy(), np.asarray(nj.cell_start))
    for f in ("max_occupancy", "max_segment", "occupied_cells", "grid_escapes"):
        assert int(getattr(eager, f)) == int(getattr(nj, f)), f
    assert float(eager.dx_acc) == (0.0 if rebuild else float(dj))
    assert int(eager.rebuilds) == int(st.rebuilds) + rebuild

    # in a chunk: the same values, written into the no-rebuild tensors
    buf = S._Buffers(st)
    buf.load(st, 1.0, dx, None)
    seen = []

    def branch(flag, body):
        seen.append(bool(flag))
        S._host_branch(flag, body)

    dx_in = buf.dx.clone()
    inplace = S._lazy_rebuild(cfg, buf.state, buf.state.particles, dx_in, branch)
    assert seen == [rebuild]
    assert inplace.particles is buf.state.particles and inplace.dx_acc is dx_in
    assert inplace.cell_start is buf.state.cell_start
    for a, b in zip(inplace.particles.tensors(), eager.particles.tensors()):
        assert torch.equal(a, b)
    for a, b in zip(inplace[1:], eager[1:]):
        assert torch.equal(a, b)


def _tie_h():
    """A smoothing length whose f32 rounding lies below it."""
    for dx in (0.05, 0.045, 0.055, 0.06, 0.04):
        h = float(np.sqrt(3 * dx ** 2))
        if float(np.float32(h)) < h:
            return dx, h
    raise AssertionError("no spacing with f32(h) < h")


def tie_case(M, **kw):
    """The f32 3D dam break on that smoothing length, for either package
    ``M``, in chunks of 4; and h."""
    dx_case, h = _tie_h()
    pos, dens, ptype, grp, idp = dam_break_3d(dx_case)
    const = M.SimulationConstants(dx=dx_case, c0=33.14, alpha=0.1, m0=1000 * dx_case ** 3,
                                  cfl=0.2)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 3, h=h)
    meta = M.SimulationMetaData(simulation_name="tie", save_location=".", dims=3,
                                dtype="float32", max_steps_per_call=4)
    sim = M.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const, kern,
                                M.ViscosityModel.ARTIFICIAL,
                                M.DensityDiffusionModel.LINEAR, **kw)
    return sim, h


def still(state):
    """``state`` with ``position_half`` at ``position``: stage 00 adds 0 to
    the accumulator, so stage 02 sees the accumulator handed in."""
    return state.replace(position_half=state.particles.position)


def test_decisions_in_the_state_dtype_on_a_constructed_tie():
    """Stage 02 and the chunk's guard compare in the state's dtype, as the
    JAX package compares (``dx_acc >= kern.h`` with a weakly typed ``h``,
    ``t_out`` in the state's dtype): an f32 accumulator equal to f32(h) < h
    rebuilds, and a total time equal to f32(t_out) > t_out steps on - in
    JAX's ``lax.cond`` and while-loop guard, in the chunk's buffers and in
    the eager chunk alike."""
    sim, h = tie_case(T, device="cpu")
    sim_j, _ = tie_case(J)
    st = S.make_fixed_steps_fn(sim.cfg, 2)(sim.state)
    tie = torch.tensor(np.float32(h))
    assert float(tie) < h
    assert bool(tie >= h)          # torch's f32 compare with the Python double
    assert bool(jnp.float32(h) >= h)   # the JAX package's compare
    # stage 02 alone: eager, and in a chunk's buffers
    kept = S._lazy_rebuild(sim.cfg, st, st.particles, tie)
    assert kept.particles is not st.particles and int(kept.rebuilds) == int(st.rebuilds) + 1
    buf = S._Buffers(st)
    buf.load(st, 1.0, tie, None)
    seen = []
    S._lazy_rebuild(sim.cfg, buf.state, buf.state.particles, buf.dx,
                    lambda flag, body: seen.append(bool(flag)))
    assert seen == [True]
    # a whole step from the tie: JAX's lax.cond rebuilds (the accumulator it
    # hands on is reset), and so do the port's chunk and eager chunk
    _, dj = jax.jit(lambda s, d: j_step(sim_j.cfg, s, d))(
        still(sim_j.state), jnp.float32(h))
    assert float(dj) == 0.0
    one = int(st.iteration) + 1
    for chunk in (S.make_chunk_body(sim.cfg), S._eager_chunk(sim.cfg)):
        out, dx = chunk(still(st), 1.0, tie, one)
        assert int(out.rebuilds) == int(st.rebuilds) + 1 and float(dx) == 0.0
        below = torch.tensor(np.nextafter(np.float32(h), np.float32(0)))
        out, dx = chunk(still(st), 1.0, below, one)
        assert int(out.rebuilds) == int(st.rebuilds) and float(dx) == float(below)

    t_out = 0.1
    assert float(np.float32(t_out)) > t_out
    at_tie = st.replace(total_time=torch.tensor(np.float32(t_out)))
    dx = S._initial_dx_acc(sim.cfg, at_tie)
    out, _ = S.make_chunk_body(sim.cfg)(at_tie, t_out, dx)
    eager, _ = S._eager_chunk(sim.cfg)(at_tie, t_out, dx)
    assert int(out.iteration) == int(eager.iteration) == int(st.iteration) + 1
    sj = sim_j.state.replace(total_time=jnp.float32(t_out))
    oj, _ = jax.jit(j_chunk_body(sim_j.cfg))(sj, jnp.asarray(t_out, dtype=jnp.float32),
                                             jnp.float32(1.0 + h))
    assert int(oj.iteration) == int(sj.iteration) + 1
    # one representable step above: nobody steps
    above = st.replace(total_time=torch.tensor(np.nextafter(np.float32(t_out),
                                                            np.float32(1))))
    out, _ = S.make_chunk_body(sim.cfg)(above, t_out, dx)
    eager, _ = S._eager_chunk(sim.cfg)(above, t_out, dx)
    assert int(out.iteration) == int(eager.iteration) == int(st.iteration)
    # the interval loop ends on the same test: a state at f32(t_out) takes a step
    interval = S.make_interval_fn(sim.cfg)
    assert int(interval(at_tie, t_out).iteration) == int(st.iteration) + 1


def _interval_pair(sim_t, sim_j, t_outs):
    ft, fj = sim_t.interval_fn, j_interval_fn(sim_j.cfg)
    st, sj = sim_t.state, sim_j.state
    for t_out in t_outs:
        st = ft(st, t_out)
        sj = fj(sj, jnp.asarray(t_out, dtype=jnp.float64))
        _agree(st, sj)
    return st


def test_wedge_mdbc_interval_matches_jax():
    """The mini mDBC still wedge through ``make_interval_fn``, two intervals
    in chunks of 4, against JAX ``make_interval_fn``."""
    sim_t, *_ = _wedge(T, device="cpu")
    sim_j, *_ = _wedge(J)
    sim_t.cfg = dataclasses.replace(sim_t.cfg, meta=T.replace(sim_t.meta,
                                                              max_steps_per_call=4))
    sim_t.interval_fn = S.make_interval_fn(sim_t.cfg)
    dt = 0.3 * sim_t.cfg.spec.kernel.h / 40.0
    st = _interval_pair(sim_t, sim_j, (7.5 * dt, 15.5 * dt))
    assert int(st.iteration) > 8 and np.abs(st.particles.density[:18].numpy()
                                            - 1000.0).max() > 1e-6


def test_moving_square_interval_matches_jax():
    """The mini moving square (prescribed motion, PLANAR, STORE) through
    ``make_interval_fn``, two intervals, against JAX ``make_interval_fn``."""
    sim_t, *_ = _square(T, speed=5.0, device="cpu")
    sim_j, *_ = _square(J, speed=5.0)
    dt = 0.3 * sim_t.cfg.spec.kernel.h / 30.0
    st = _interval_pair(sim_t, sim_j, (6.5 * dt, 13.5 * dt))
    assert int(st.iteration) > 8 and float(st.particles.kernel_w.min()) > 0


def _storages(state):
    return {a.untyped_storage().data_ptr() for a in state_leaves(state)}


def test_chunk_buffers_share_no_storage():
    """A state handed out by a chunk shares no storage with the chunk's
    buffers or with the state handed in, and the next chunk leaves it as it
    was (what the asynchronous saver and the replay after a grid escape
    rest on)."""
    sim = _assemble_port()
    chunk = S.make_chunk_body(dataclasses.replace(
        sim.cfg, meta=T.replace(sim.meta, max_steps_per_call=3)))
    dx = S._initial_dx_acc(sim.cfg, sim.state)
    before = [a.clone() for a in state_leaves(sim.state)]
    out, dx = chunk(sim.state, 1.0, dx)
    buf = chunk.buffers
    owned = _storages(buf.state) | {t.untyped_storage().data_ptr() for t in
                                    (buf.dx, buf.t_out, buf.stop, buf.live, buf.rebuild)}
    assert not (_storages(out) & owned)
    assert not (_storages(out) & _storages(sim.state))
    assert dx.untyped_storage().data_ptr() not in owned
    assert all(torch.equal(a, b) for a, b in zip(before, state_leaves(sim.state)))
    kept = [a.clone() for a in state_leaves(out)]
    nxt, _ = chunk(out, 1.0, dx)
    assert chunk.buffers is buf and int(nxt.iteration) == int(out.iteration) + 3
    assert all(torch.equal(a, b) for a, b in zip(kept, state_leaves(out)))


def test_sharded_chunk_is_eager_by_its_context(monkeypatch):
    """``make_chunk_body`` routes a sharded config by where its slabs lie
    (its context's devices): all on the CPU or on one card, the buffered
    chunk of every slab (on the card one graph); on several cards, the
    eager chunk.  On the CPU the sharded interval function runs with the
    eager chunk made unusable, through one set of buffers per slab."""
    from sphexample_tpu_torch.parallel.context import CommContext, LocalGroup

    sim = shard_simulation(_assemble_port(), make_mesh(2, "cpu"))
    chunk = S.make_chunk_body(sim.cfg)
    assert chunk.route == "graph"

    def routed(*devices):
        ctx = CommContext(LocalGroup([torch.device(d) for d in devices]), 0)
        return S.make_chunk_body(dataclasses.replace(sim.cfg, ctx=ctx)).route

    assert routed("cuda:0", "cuda:0", "cuda:0", "cuda:0") == "graph"
    assert routed("cuda:0", "cuda:1") == routed("cuda:0", "cuda:1", "cuda:0") == "eager"

    def refused(*args, **kwargs):
        raise AssertionError("a sharded run on the CPU took the eager chunk")

    monkeypatch.setattr(S, "_eager_chunk", refused)
    interval = S.make_interval_fn(sim.cfg)
    states = interval(sim.state, 0.001)
    assert len(states) == 2 and float(states[0].total_time) > 0.001
    assert int(states[0].iteration) == int(states[1].iteration) > 1
    bufs = interval.chunk.buffers
    assert len(bufs) == 2 and [b.state.total_time.device.type for b in bufs] == ["cpu"] * 2


def test_rebuild_counter_and_old_checkpoint(tmp_path):
    """``rebuilds`` is a device counter: an int given to the state becomes
    an int32 scalar on its device; a checkpoint stores it as an int (as the
    files before it did) and loads back; a file without the key (the JAX
    package's) loads with 0."""
    sim = _assemble_port()
    st = sim.state.replace(rebuilds=7)
    assert isinstance(st.rebuilds, torch.Tensor) and st.rebuilds.dtype == torch.int32
    assert st.rebuilds.device == st.total_time.device and int(st.rebuilds) == 7
    path = tmp_path / "old.npz"
    save_checkpoint(str(path), st, 3)
    with np.load(path) as data:
        arrays = dict(data)
    assert arrays["rebuilds"].dtype.kind == "i" and arrays["rebuilds"].shape == ()
    np.savez_compressed(path, **arrays)     # an int, as older files stored it
    back, counter = load_checkpoint(str(path), sim.state)
    assert counter == 3 and int(back.rebuilds) == 7
    assert back.rebuilds.dtype == torch.int32
    del arrays["rebuilds"]
    np.savez_compressed(path, **arrays)
    back, _ = load_checkpoint(str(path), sim.state)
    assert int(back.rebuilds) == 0
