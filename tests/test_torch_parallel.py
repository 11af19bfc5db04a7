"""The port's communication context (``parallel/context.py``): the five
collectives of the JAX ``CommContext`` and the 1-hop ``exchange``
on 4 thread ranks (CPU tensors), the zero fill at the two end ranks, an
exception in one rank re-raised by the caller within the timeout, a rank that
never arrives, and the identities of ``SINGLE``.  The JAX collectives run
under ``shard_map`` on 4 virtual CPU devices, on the same numpy inputs."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sphexample_tpu.parallel.context import CommContext as JCtx
from sphexample_tpu.parallel.mesh import AXIS
from sphexample_tpu.parallel.mesh import make_mesh as j_make_mesh
from sphexample_tpu_torch.parallel.context import (SINGLE, CommContext, LocalGroup,
                                                   run_ranks)
from sphexample_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
N = 4
ROWS = 3


def _inputs():
    rng = np.random.default_rng(3)
    return rng.normal(size=(N * ROWS, 2)), rng.normal(size=N), rng.integers(0, 9, size=N)


def _on_ranks(fn, timeout=20.0):
    group = LocalGroup(["cpu"] * N, timeout=timeout)
    return run_ranks(group, lambda r: fn(CommContext(group, r), r))


def test_collectives_match_jax_shard_map():
    x, s, k = _inputs()
    ctx = JCtx(axis=AXIS, num_devices=N)

    def body(xs, ss, ks):
        return (ctx.gather(xs), ctx.pmax(ss[0]), ctx.pmin(ss[0]), ctx.psum(ks[0]),
                jnp.reshape(ctx.rank(), (1,)))

    want = jax.jit(shard_map(body, mesh=j_make_mesh(N), in_specs=(P(AXIS),) * 3,
                             out_specs=(P(), P(), P(), P(), P(AXIS)), check_vma=False))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(k))

    def rank_fn(c, r):
        assert c.is_sharded and c.num_devices == N and c.rank() == r
        return (c.gather(torch.as_tensor(x[r * ROWS:(r + 1) * ROWS])),
                c.pmax(torch.as_tensor(s[r])), c.pmin(torch.as_tensor(s[r])),
                c.psum(torch.as_tensor(k[r])))

    for r, (g, mx, mn, sm) in enumerate(_on_ranks(rank_fn)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[0]))   # every rank: all
        assert float(mx) == float(want[1]) == s.max()
        assert float(mn) == float(want[2]) == s.min()
        assert int(sm) == int(want[3]) == k.sum() and sm.dtype == torch.int64
        assert int(want[4][r]) == r


@pytest.mark.parametrize("direction", [1, -1])
def test_exchange_matches_ppermute_with_zeros_at_the_ends(direction):
    """Each half of ``exchange`` is one ``lax.ppermute`` by one rank:
    ``from_left`` is the shift by +1, ``from_right`` the shift by -1, and the
    end rank of either receives zeros of the shape sent."""
    x, _, _ = _inputs()
    perm = ([(i, i + 1) for i in range(N - 1)] if direction == 1
            else [(i + 1, i) for i in range(N - 1)])
    want = np.asarray(jax.jit(shard_map(
        lambda xs: jax.lax.ppermute(xs, AXIS, perm), mesh=j_make_mesh(N),
        in_specs=(P(AXIS),), out_specs=P(AXIS), check_vma=False))(jnp.asarray(x)))

    def rank_fn(c, r):
        rows = torch.as_tensor(x[r * ROWS:(r + 1) * ROWS])
        return c.exchange(rows, rows)[0 if direction == 1 else 1]

    got = _on_ranks(rank_fn)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    end = 0 if direction == 1 else N - 1
    assert not got[end].any() and got[end].shape == (ROWS, 2)


def test_exchange_is_both_shifts_in_one_rendezvous():
    x, _, k = _inputs()

    def rank_fn(c, r):
        rows = torch.as_tensor(x[r * ROWS:(r + 1) * ROWS])
        tag = torch.full((2,), int(k[r]))
        single = c.exchange(rows[:1], rows[-1:])
        pair = c.exchange((rows[:1], tag), (rows[-1:], tag + 100))
        # the received tensors are this rank's own copies: writing into one
        # changes nothing a neighbour holds
        kept = (single[0].clone(), single[1].clone())
        single[0].fill_(7.0)
        single[1].fill_(7.0)
        return kept, pair

    out = _on_ranks(rank_fn)
    for r, ((from_l, from_r), (pl, pr)) in enumerate(out):
        want_l = x[r * ROWS - 1][None] if r > 0 else np.zeros((1, 2))
        want_r = x[(r + 1) * ROWS][None] if r < N - 1 else np.zeros((1, 2))
        np.testing.assert_array_equal(from_l.numpy(), want_l)
        np.testing.assert_array_equal(from_r.numpy(), want_r)
        np.testing.assert_array_equal(pl[0].numpy(), want_l)
        np.testing.assert_array_equal(pr[0].numpy(), want_r)
        assert pl[1].tolist() == ([int(k[r - 1]) + 100] * 2 if r > 0 else [0, 0])
        assert pr[1].tolist() == ([int(k[r + 1])] * 2 if r < N - 1 else [0, 0])


def test_exception_in_one_rank_is_reraised_within_the_timeout():
    def rank_fn(c, r):
        c.pmax(torch.tensor(float(r)))
        if r == 2:
            raise ZeroDivisionError("rank 2 failed")
        return c.psum(torch.tensor(1))      # the others wait here

    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError, match="rank 2"):
        _on_ranks(rank_fn, timeout=20.0)
    assert time.perf_counter() - t0 < 10.0   # the barrier was aborted, not timed out
    # the group of a failed run is not left broken: a new run works
    group = LocalGroup(["cpu"] * N, timeout=20.0)
    with pytest.raises(ZeroDivisionError):
        run_ranks(group, lambda r: 1 // 0 if r == 0 else CommContext(group, r).pmax(
            torch.tensor(1.0)))
    assert [int(v) for v in run_ranks(
        group, lambda r: CommContext(group, r).psum(torch.tensor(1)))] == [N] * N


def test_rank_that_never_arrives_times_out():
    def rank_fn(c, r):
        if r == 1:
            return None                      # leaves without taking part
        return c.pmax(torch.tensor(1.0))

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        _on_ranks(rank_fn, timeout=0.5)
    assert time.perf_counter() - t0 < 10.0
    assert threading.active_count() < 20     # no rank thread left behind


def test_collectives_under_stress():
    """More ranks than cores, a very short thread switch interval, hundreds of
    rendezvous back to back: every round's sum, neighbours and gather are that round's - a
    posted tensor read late, or a board slot overwritten early, would break
    them."""
    n, rounds = 12, 100
    group = LocalGroup(["cpu"] * n, timeout=60.0)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def rank_fn(r):
        c = CommContext(group, r)
        bad = 0
        for k in range(rounds):
            x = torch.tensor([float(r * 1000 + k)])
            total = c.psum(torch.tensor(r + k))
            left, right = c.exchange(x, x)
            allx = c.gather(x)
            bad += int(total) != n * k + n * (n - 1) // 2
            bad += float(left) != (0.0 if r == 0 else (r - 1) * 1000 + k)
            bad += float(right) != (0.0 if r == n - 1 else (r + 1) * 1000 + k)
            bad += allx.tolist() != [float(q * 1000 + k) for q in range(n)]
        return bad

    t0 = time.perf_counter()
    try:
        assert run_ranks(group, rank_fn) == [0] * n
    finally:
        sys.setswitchinterval(before)
    assert time.perf_counter() - t0 < 120.0
    assert not group.turn.locked()    # the turn was handed back


def test_single_context_is_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert not SINGLE.is_sharded and SINGLE.num_devices == 1 and SINGLE.rank() == 0
    for method in (SINGLE.gather, SINGLE.pmax, SINGLE.pmin, SINGLE.psum):
        assert method(x) is x
    left, right = SINGLE.exchange(x[:1], x[-1:])
    assert not left.any() and not right.any() and left.shape == right.shape == (1, 2)


def test_make_mesh_maps_ranks_to_devices(monkeypatch):
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    mesh = make_mesh(4, "cpu")
    assert mesh.size == 4 and all(d.type == "cpu" for d in mesh.devices)
    # no card: the default (the cards) raises, the port never drops to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)
    # two cards: slab r goes to card r mod 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [d.index for d in make_mesh(4).devices] == [0, 1, 0, 1]
    assert make_mesh().size == 2
    assert [d.index for d in make_mesh(3, "cuda:1").devices] == [1, 1, 1]
