"""The chunk of all slabs of a sharded run (``core/step.py:make_chunk_body``
with a sharded context; on the card one CUDA graph for every slab), on the
CPU with thread ranks and CPU tensors, in f64 on the tall column of
tests/test_torch_sharded_step.py with its fluid thrown up at 24 m/s (a
rebuild every four or five steps, so that rebuilds fall inside chunks of 4;
a falling column would pile onto the floor, and its time step collapse,
before it moved a cell):

* on 2 and 4 ranks against the JAX package's ``make_sharded_interval_fn``
  (``jit(shard_map(make_chunk_body))``, its all-gather XLA path on 2 and 4
  of the 8 virtual devices of tests/conftest.py), within the f64 tolerances
  of tests/test_sweep.py:103-107, one JAX run per rank count for the module;
* against the eager chunk of the same slabs (``_eager_chunk``: the ranks'
  host loops, the route of slabs on several cards) bit for bit;
* one ``_host_read`` per chunk for all ranks; one set of buffers per rank,
  sharing no storage with the states handed in or out;
* the decisions in the state's dtype on a constructed tie, on 2 ranks;
* no host read and no copy from the host in what the card captures of a
  sharded step, on the three sharded paths (B2, B2 + B4 on the halo, B3s).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.parallel.mesh import make_mesh as j_make_mesh
from sphexample_tpu.parallel.mesh import shard_simulation as j_shard
from sphexample_tpu_torch.core import step as S
from sphexample_tpu_torch.parallel.context import run_ranks
from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation
from sphexample_tpu_torch.state import gather_state, state_leaves
from test_torch_chunk import still, tie_case
from test_torch_sharded_step import _by_id, _tall

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-8   # tests/test_sweep.py:103-107
CHUNK = 4
STEPS = 14                 # the interval's steps: chunks of 4, 4, 4 and 2
RISE = 24.0                # m/s, the fluid's start velocity (up)


def _rising(M, chunk=CHUNK, **kw):
    """The tall column of either package ``M`` with its fluid thrown up at
    ``RISE`` and chunks of ``chunk`` steps."""
    sim = _tall(M, block=False, **kw)
    p = sim.state.particles
    lib = jnp if M is J else torch
    v = lib.stack([lib.zeros_like(p.density), RISE * p.motion_limiter], axis=1)
    sim.state = sim.state.replace(particles=p.replace(velocity=v))
    meta = M.replace(sim.meta, max_steps_per_call=chunk)
    sim.meta, sim.cfg = meta, dataclasses.replace(sim.cfg, meta=meta)
    return sim


def _t_out():
    """An output time between the single-device port's steps 13 and 14 from
    the start: the interval takes ``STEPS`` steps, on any slab count."""
    sim = _rising(T, device="cpu")
    s, dx, times = sim.state, S._initial_dx_acc(sim.cfg, sim.state), []
    for _ in range(STEPS):
        s, dx = S.sph_step(sim.cfg, s, dx)
        times.append(float(s.total_time))
    return 0.5 * (times[STEPS - 2] + times[STEPS - 1])


@pytest.fixture(scope="module")
def t_out():
    return _t_out()


@pytest.fixture(scope="module", params=[2, 4])
def jax_run(request, t_out):
    """The JAX package on ``n`` virtual devices (its all-gather XLA path):
    the interval to ``t_out`` in chunks of 4; (n, its padded capacity before
    sharding, the end state)."""
    n = request.param
    single = _rising(J, use_pallas=False)
    sim_j = j_shard(single, j_make_mesh(n))
    end = sim_j.interval_fn(sim_j.state, jnp.asarray(t_out, dtype=jnp.float64))
    return n, single.state.particles.capacity, end


def _port(n, capacity=None):
    return shard_simulation(_rising(T, device="cpu", capacity=capacity),
                            make_mesh(n, "cpu"))


def test_joint_chunk_matches_jax_shard_map(jax_run, t_out):
    """The interval of all slabs in chunks of 4 against JAX's ``shard_map``
    of its chunk body: the same steps, sorted order and ``cell_start``, the
    fields by particle id within the f64 tolerances, rebuilds inside the
    chunks on every rank."""
    n, cap, fj = jax_run
    sharded = _port(n, cap)
    assert sharded.interval_fn.chunk.route == "graph"
    r0 = [int(s.rebuilds) for s in sharded.state]
    states = sharded.interval_fn(sharded.state, t_out)
    assert len(states) == n and int(states[0].iteration) == STEPS == int(fj.iteration)
    rebuilds = [int(s.rebuilds) - r for s, r in zip(states, r0)]
    assert len(set(rebuilds)) == 1 and rebuilds[0] >= 3    # the first step's, and two more
    ft = gather_state(states)
    np.testing.assert_array_equal(ft.particles.id.numpy(), np.asarray(fj.particles.id))
    np.testing.assert_array_equal(ft.cell_start.numpy(), np.asarray(fj.cell_start))
    ids_t, ids_j = ft.particles.id.numpy(), np.asarray(fj.particles.id)
    for f in ("position", "velocity", "density"):
        np.testing.assert_allclose(_by_id(ids_t, getattr(ft.particles, f).numpy()),
                                   _by_id(ids_j, getattr(fj.particles, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert float(ft.total_time) == pytest.approx(float(fj.total_time), rel=RTOL)


def _counted_reads(monkeypatch):
    reads, real = [0], S._host_read

    def counted(state, prev):
        reads[0] += 1
        return real(state, prev)

    monkeypatch.setattr(S, "_host_read", counted)
    return reads


@pytest.mark.parametrize("n", [2, 4])
def test_joint_chunk_is_the_eager_chunk_bit_for_bit(n, t_out, monkeypatch):
    """Two intervals through the buffered chunk of all slabs and through the
    ranks' eager chunk (their host loops, each decision a host read): every
    tensor of every slab bit for bit, the same steps; the buffered one reads
    the host once per chunk for all ranks."""
    sharded = _port(n)
    reads = _counted_reads(monkeypatch)
    t_outs = (t_out, 2 * t_out)
    graph, eager = sharded.state, sharded.state
    eager_interval = S.make_chunk_loop(sharded.cfg, S._eager_chunk(sharded.cfg))
    chunks = 0
    for t in t_outs:
        it0 = int(graph[0].iteration)
        graph = sharded.interval_fn(graph, t)
        chunks += -(-(int(graph[0].iteration) - it0) // CHUNK)
    assert reads[0] == chunks
    for t in t_outs:
        eager = eager_interval(eager, t)
    assert int(graph[0].iteration) == int(eager[0].iteration) > STEPS
    for a, b in zip(graph, eager):
        assert all(torch.equal(x, y) for x, y in zip(state_leaves(a), state_leaves(b)))


def _storages(state):
    return {a.untyped_storage().data_ptr() for a in state_leaves(state)}


def test_joint_chunk_buffers_per_rank_share_no_storage(t_out):
    """One set of buffers per rank: none shares storage with another rank's,
    with the states handed in or with those handed out, and the next chunk
    leaves a handed-out state as it was."""
    sharded = _port(2)
    chunk = sharded.interval_fn.chunk
    before = [[a.clone() for a in state_leaves(s)] for s in sharded.state]
    dx = S._initial_dx_acc(sharded.cfg, sharded.state)
    out, dx = chunk(sharded.state, t_out, dx)
    bufs = chunk.buffers
    owned = [_storages(b.state) | {t.untyped_storage().data_ptr() for t in
                                   (b.dx, b.t_out, b.stop, b.live, b.rebuild)} for b in bufs]
    assert len(bufs) == 2 and not owned[0] & owned[1]
    for s_in, s_out, d in zip(sharded.state, out, dx):
        assert not _storages(s_out) & (owned[0] | owned[1])
        assert not _storages(s_out) & _storages(s_in)
        assert d.untyped_storage().data_ptr() not in owned[0] | owned[1]
    for kept, s in zip(before, sharded.state):
        assert all(torch.equal(a, b) for a, b in zip(kept, state_leaves(s)))
    kept = [[a.clone() for a in state_leaves(s)] for s in out]
    nxt, _ = chunk(out, t_out, dx)
    assert chunk.buffers is bufs and int(nxt[1].iteration) == int(out[1].iteration) + CHUNK
    for k, s in zip(kept, out):
        assert all(torch.equal(a, b) for a, b in zip(k, state_leaves(s)))


def test_decisions_in_the_state_dtype_on_two_ranks():
    """The constructed tie of tests/test_torch_chunk.py on 2 slabs, through
    the buffered chunk of all slabs and the ranks' eager chunk: an f32
    accumulator equal to f32(h) < h rebuilds on every rank (one
    representable step below does not), and a total time equal to
    f32(t_out) > t_out steps on (one step above does not)."""
    sim, h = tie_case(T, device="cpu")
    sharded = shard_simulation(sim, make_mesh(2, "cpu"))
    st = S.make_fixed_steps_fn(sharded.cfg, 2)(sharded.state)
    it, r = int(st[0].iteration), [int(s.rebuilds) for s in st]
    one = tuple(still(s) for s in st)

    def dxs(v):
        return tuple(torch.tensor(v) for _ in st)

    below = np.nextafter(np.float32(h), np.float32(0))
    for chunk in (S.make_chunk_body(sharded.cfg), S._eager_chunk(sharded.cfg)):
        out, dx = chunk(one, 1.0, dxs(np.float32(h)), it + 1)
        assert [int(s.rebuilds) for s in out] == [k + 1 for k in r]
        assert all(float(d) == 0.0 for d in dx)
        out, dx = chunk(one, 1.0, dxs(below), it + 1)
        assert [int(s.rebuilds) for s in out] == r
        assert all(float(d) == float(below) for d in dx)

    t_out = 0.1
    assert float(np.float32(t_out)) > t_out
    for t, steps in ((np.float32(t_out), 1), (np.nextafter(np.float32(t_out), 1), 0)):
        at = tuple(s.replace(total_time=torch.tensor(t)) for s in st)
        dx = S._initial_dx_acc(sharded.cfg, at)
        for chunk in (S.make_chunk_body(sharded.cfg), S._eager_chunk(sharded.cfg)):
            out, _ = chunk(at, t_out, dx)
            assert [int(s.iteration) for s in out] == [it + steps] * 2


class _NoHostRead(TorchFunctionMode):
    """Raises on what a captured step may not do on the card: read a device
    value on the host, or copy host data to the device."""

    BANNED = {torch.tensor, torch.as_tensor, torch.from_numpy, torch.bincount,
              torch.nonzero, torch.unique, torch.masked_select, torch.Tensor.item,
              torch.Tensor.tolist, torch.Tensor.__bool__, torch.Tensor.__int__,
              torch.Tensor.__float__, torch.Tensor.cpu, torch.Tensor.numpy,
              torch.Tensor.nonzero, torch.Tensor.unique}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise AssertionError(f"a host read or copy in the captured step: {func}")
        if func is torch.Tensor.__getitem__:
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
                raise AssertionError("a boolean mask index in the captured step")
        return func(*args, **kwargs)


def _outside_the_mode(fn):
    """``fn`` with no torch-function mode active: a plain version that the
    card replaces with its kernel."""
    def plain(*args, **kwargs):
        with torch._C.DisableTorchFunction():
            return fn(*args, **kwargs)
    return plain


@pytest.mark.parametrize("mdbc,block", [(False, True), (True, True), (False, False)])
def test_sharded_step_reads_nothing_from_the_host(mdbc, block, monkeypatch):
    """What the card captures of a sharded step - every rank's step with
    stage 02's rebuild taken, its collectives and the guard - makes no host
    read and copies nothing from the host once one step ran (the warm-up
    fills the step's caches of device constants): on the card either would
    fail the capture.  Here the ranks' steps on CPU tensors run under a mode
    that raises on them; the plain sweep and the plain mDBC moments and
    solve, which the card replaces with its kernels, run outside it."""
    from sphexample_tpu_torch.ops import block_sweep as bs
    from sphexample_tpu_torch.ops import mdbc as mdbc_mod

    monkeypatch.setattr(bs, "pair_sweep", _outside_the_mode(bs.pair_sweep))
    for name in ("mdbc_moments_plain", "_mdbc_apply"):
        monkeypatch.setattr(mdbc_mod, name, _outside_the_mode(getattr(mdbc_mod, name)))
    sharded = shard_simulation(_tall(T, mdbc, block, device="cpu"), make_mesh(4, "cpu"))
    cfg = sharded.cfg
    group = cfg.ctx.group
    bufs = [S._Buffers(s) for s in sharded.state]
    dxs = S._initial_dx_acc(cfg, sharded.state)
    for b, s, d in zip(bufs, sharded.state, dxs):
        b.load(s, 1.0, d, None)
    cfgs = [dataclasses.replace(cfg, ctx=cfg.ctx.for_rank(r)) for r in range(4)]
    run_ranks(group, lambda r: bufs[r].step(dataclasses.replace(cfgs[r],
                                                                branch=S._host_branch)))
    taken = [0] * 4

    def captured(r):
        def branch(flag, body):
            taken[r] += 1
            body()

        with _NoHostRead():
            bufs[r].set_live()
            bufs[r].step(dataclasses.replace(cfgs[r], branch=branch))

    run_ranks(group, captured)
    assert taken == [1] * 4 and all(int(b.state.rebuilds) == 2 for b in bufs)
