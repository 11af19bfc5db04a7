"""Prescribed motion: the port's ``build_motion_table`` and ``progress_motion``
against the JAX package's on random states in f64, bit for bit - inside the
motion window, at both of its (inclusive) edges, outside it, with an undefined
and an out-of-table group marker, and without any motion."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu.config as jc
import sphexample_tpu_torch.config as tc
from sphexample_tpu.core import motion as jm
from sphexample_tpu_torch.core import motion as tm

torch.set_num_threads(1)
START, DURATION = 0.25, 0.5


def _geometries(mod, dims):
    direction = (0.6, -0.8) if dims == 2 else (0.0, 0.6, 0.8)
    return (
        mod.Geometry("", 1, mod.ParticleType.FIXED),
        mod.Geometry("", 2, mod.ParticleType.FLUID),
        mod.Geometry("", 3, mod.ParticleType.MOVING,
                     mod.MotionDetails(2.8, START, DURATION, direction)),
        mod.Geometry("", 5, mod.ParticleType.MOVING,
                     mod.MotionDetails(-0.7, 0.0, 10.0, tuple([1.0] + [0.0] * (dims - 1)))),
    )


def _rows(dims, n=64, seed=0):
    """Random rows of every type; markers 0..7: 3 and 5 have a motion, 4 has
    none, 6 and 7 lie past the table (clipped into it)."""
    rng = np.random.default_rng(seed)
    return dict(position=rng.normal(0, 1, (n, dims)), velocity=rng.normal(0, 1, (n, dims)),
                ptype=rng.choice([1, 2, 3], size=n).astype(np.int32),
                group_marker=rng.integers(0, 8, size=n).astype(np.int32))


def _both(dims, rows, t, dt2, geoms=True):
    jt = jm.build_motion_table(_geometries(jc, dims) if geoms else (), dims)
    tt = tm.build_motion_table(_geometries(tc, dims) if geoms else (), dims)
    jp = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in rows.items()})
    tp = types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in rows.items()})
    ja = jm.progress_motion(jt, jp, jnp.asarray(t), jnp.asarray(dt2))
    ta = tm.progress_motion(tt, tp, torch.tensor(t, dtype=torch.float64),
                            torch.tensor(dt2, dtype=torch.float64))
    return jt, tt, ja, ta, tp


@pytest.mark.parametrize("dims", [2, 3])
def test_motion_table_matches_jax(dims):
    jt = jm.build_motion_table(_geometries(jc, dims), dims)
    tt = tm.build_motion_table(_geometries(tc, dims), dims)
    for f in ("velocity", "start_time", "duration", "direction", "defined"):
        assert getattr(jt, f) == getattr(tt, f), f
    assert tt.any_motion and len(tt.velocity) == 6 and tt.defined[3] and not tt.defined[4]
    empty = tm.build_motion_table((), dims)
    assert not empty.any_motion and empty.velocity == (0.0,)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("t", [0.0, START, 0.5, START + DURATION,
                               float(np.nextafter(START + DURATION, 1.0)),
                               float(np.nextafter(START, 0.0)), 3.0],
                         ids=["before", "start_edge", "inside", "end_edge",
                              "just_after", "just_before", "after"])
def test_progress_motion_matches_jax_bitwise(dims, t):
    rows = _rows(dims, seed=dims)
    _, _, (jpos, jvel), (tpos, tvel), tp = _both(dims, rows, t, 1.7e-4)
    assert tpos.dtype == torch.float64
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tvel.numpy(), np.asarray(jvel))
    moving3 = (rows["ptype"] == 3) & (rows["group_marker"] == 3)
    inside = START <= t <= START + DURATION
    assert moving3.any()
    # velocity is assigned: zero outside the inclusive window
    speed = np.linalg.norm(tvel.numpy()[moving3], axis=-1)
    np.testing.assert_allclose(speed, 2.8 if inside else 0.0, rtol=1e-15, atol=0)
    # rows that are not MOVING, or whose marker has no motion, are untouched
    touched = (rows["ptype"] == 3) & np.isin(rows["group_marker"], [3, 5, 6, 7])
    assert np.array_equal(tpos.numpy()[~touched], rows["position"][~touched])
    assert np.array_equal(tvel.numpy()[~touched], rows["velocity"][~touched])
    # markers past the table are clipped onto its last row (marker 5)
    clipped = (rows["ptype"] == 3) & (rows["group_marker"] >= 6)
    assert clipped.any()
    np.testing.assert_array_equal(tvel.numpy()[clipped][:, 0], -0.7)


def test_no_motion_is_a_no_op_and_tables_are_cached():
    rows = _rows(2)
    _, tt, _, (tpos, tvel), tp = _both(2, rows, 0.5, 1e-4, geoms=False)
    assert tpos is tp.position and tvel is tp.velocity
    table = tm.build_motion_table(_geometries(tc, 2), 2)
    a = tm._table_tensors(table, torch.device("cpu"), torch.float64)
    b = tm._table_tensors(tm.build_motion_table(_geometries(tc, 2), 2),
                          torch.device("cpu"), torch.float64)
    assert all(x is y for x, y in zip(a, b))   # made once per table and device
