"""The port's cell list matches JAX ``cl.rebuild`` / ``cl.row_segments`` bit
for bit, in f64 and f32: a jittered lattice shifted off the map_floor
half-integer boundary (the OFF shift of test_trajectory.py) plus inactive
padding rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.state import allocate_particles as j_alloc
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.state import allocate_particles as t_alloc

torch.set_num_threads(1)
OFF = 0.0037


def _lattice(dims, n, seed, dx=0.05):
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * dx] * dims), indexing="ij"),
                      axis=-1).reshape(-1, dims)[:n]
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * dx
    pos -= pos.mean(axis=0)
    pos += OFF
    ptype = rng.choice([1, 2], size=n).astype(np.int32)
    # shuffled ids: the sort must follow the keys, ties in id order
    ids = rng.permutation(n) + 1
    return pos, ptype, ids


def _both(dims, dtype, n=300, cap=360, seed=0):
    pos, ptype, ids = _lattice(dims, n, seed)
    dens = np.full(n, 1000.0)
    gm = np.ones(n, np.int32)
    jp = j_alloc(pos, dens, ptype, gm, ids, capacity=cap,
                 dtype=jnp.float64 if dtype == "float64" else jnp.float32)
    tp = t_alloc(pos, dens, ptype, gm, ids, capacity=cap, device="cpu",
                 dtype=getattr(torch, dtype))
    inv = 1.0 / (2 * 2 * 0.05)
    grid = jcl.grid_from_positions(pos, inv, margin_cells=2)
    return jp, tp, inv, grid, pos


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rebuild_bitwise(dims, dtype):
    jp, tp, inv, jgrid, pos = _both(dims, dtype)
    tgrid = tcl.grid_from_positions(pos, inv, margin_cells=2)
    assert (tgrid.cmin, tgrid.shape) == (jgrid.cmin, jgrid.shape)
    assert tgrid.strides == jgrid.strides and tgrid.ncells == jgrid.ncells

    np.testing.assert_array_equal(
        np.asarray(jcl.cell_coords(jp.position, inv)),
        tcl.cell_coords(tp.position, inv).numpy())

    js, jcs, jocc = jcl.rebuild(jp, inv, jgrid)
    ts, tcs, tocc = tcl.rebuild(tp, inv, tgrid)
    for f in ("id", "cell", "position", "active", "ptype"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jcs), tcs.numpy())
    assert tcs.dtype == torch.int32 and int(jocc) == int(tocc)
    assert int(jcl.max_row_segment(jcs, jgrid)) == int(tcl.max_row_segment(tcs, tgrid))

    jst, jen = jcl.row_segments(js.cell, jgrid, jcs)
    tst, ten = tcl.row_segments(ts.cell, tgrid, tcs)
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    np.testing.assert_array_equal(np.asarray(jen), ten.numpy())
    # padding parks past every stencil row
    assert not ts.active[-60:].any() and int(tcs[-2]) == 300


def test_keys_clamp_and_park():
    """Escapees clamp into edge cells; inactive rows take the parking key."""
    jp, tp, inv, grid, pos = _both(3, "float64", n=50, cap=64)
    far = np.zeros((64, 3))
    far[:3] = [[50.0, 0, 0], [-50.0, 0, 0], [0, 0, 80.0]]
    jp = jp.replace(position=jp.position + jnp.asarray(far))
    tp = tp.replace(position=tp.position + torch.as_tensor(far))
    jk, jc = jcl.sort_keys(jp, inv, grid)
    tk, tc_ = tcl.sort_keys(tp, inv, grid)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc_.numpy())
    assert (tk[50:] == grid.ncells).all()


@pytest.mark.parametrize("dims", [2, 3])
def test_stencil_rows(dims):
    np.testing.assert_array_equal(jcl.stencil_rows(dims), tcl.stencil_rows(dims))


def test_segment_starts():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 41, 500)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jcl.segment_starts(jnp.asarray(keys), 40)),
        tcl.segment_starts(torch.as_tensor(keys), 40).numpy())
