"""The port's pruned neighbor list (``ops/neighbor_list.py``, plain PyTorch)
against the JAX package's on tests/test_neighbor_list.py's two cases, on the
same inputs (tests/test_sweep.py:_setup, f64): the list itself, its
``max_count``, the list sweep against JAX's list sweep and against both
packages' stencil sweeps (the tolerance of tests/test_neighbor_list.py:41),
and the skin's superset property; the list does not depend on the chunk."""

import dataclasses

import numpy as np
import pytest
import torch

import sphexample_tpu_torch.config as tc
from sphexample_tpu.config import (DensityDiffusionModel, KernelOutputMode, ShiftingMode,
                                   ViscosityModel)
from sphexample_tpu.ops.interactions import PhysicsSpec, pair_sweep
from sphexample_tpu.ops.neighbor_list import build_neighbor_list as j_build
from sphexample_tpu.ops.neighbor_list import pair_sweep_list as j_sweep_list
from sphexample_tpu_torch.ops import interactions as ti
from sphexample_tpu_torch.ops.cell_list import Grid
from sphexample_tpu_torch.ops.neighbor_list import build_neighbor_list, pair_sweep_list
from sphexample_tpu_torch.state import Particles

from test_sweep import _setup

torch.set_num_threads(1)
FIELDS = ("drhodt", "acceleration", "kernel_w", "kernel_grad", "grad_c", "div_r")
CSEG, K, BLOCK = 192, 256, 64


def _port_inputs(dims, n, seed=0):
    """tests/test_sweep.py:_setup and its port counterparts: the same sorted
    particles, grid, cell list and models."""
    const, kern, grid, p, cs = _setup(dims, n=n, seed=seed)
    tp = Particles(**{f.name: torch.tensor(np.asarray(getattr(p, f.name)))
                      for f in dataclasses.fields(Particles)})
    tconst = tc.SimulationConstants(**dataclasses.asdict(const))
    tkern = tc.make_kernel(tc.KernelFamily.WENDLAND_C2, dims, dx=const.dx)
    assert (tkern.H, tkern.h) == (kern.H, kern.h)
    jspec = PhysicsSpec(constants=const, kernel=kern,
                        viscosity=ViscosityModel.ARTIFICIAL,
                        diffusion=DensityDiffusionModel.LINEAR,
                        shifting=ShiftingMode.PLANAR, kernel_output=KernelOutputMode.STORE)
    tspec = ti.PhysicsSpec(constants=tconst, kernel=tkern,
                           viscosity=tc.ViscosityModel.ARTIFICIAL,
                           diffusion=tc.DensityDiffusionModel.LINEAR,
                           shifting=tc.ShiftingMode.PLANAR,
                           kernel_output=tc.KernelOutputMode.STORE)
    return (jspec, grid, p, cs), (tspec, Grid(grid.cmin, grid.shape), tp,
                                  torch.tensor(np.asarray(cs)))


def _sweep_args(p):
    return p, p.position, p.density, p.pressure, p.velocity


@pytest.mark.parametrize("dims", [2, 3])
def test_list_and_list_sweep_match_jax(dims):
    (jspec, jgrid, jp, jcs), (tspec, tgrid, tp, tcs) = _port_inputs(dims, 220)
    j_nbr, j_max = j_build(jspec.kernel, jgrid, CSEG, K=K, block_size=BLOCK,
                           particles=jp, cell_start=jcs)
    nbr, max_count = build_neighbor_list(tspec.kernel, tgrid, CSEG, K, BLOCK, tp, tcs)
    assert nbr.dtype == torch.int32 and nbr.shape == (220, K)
    assert int(max_count) == int(j_max) <= K
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(j_nbr))
    # the sentinel N after each row's ascending indices
    n = tp.capacity
    rows = nbr.numpy()
    assert (np.diff(rows, axis=1) >= 0).all() and (rows[:, -1] == n).all()

    out = pair_sweep_list(tspec, tgrid, nbr, BLOCK, *_sweep_args(tp))
    refs = (j_sweep_list(jspec, jgrid, j_nbr, BLOCK, *_sweep_args(jp)),
            pair_sweep(jspec, jgrid, CSEG, BLOCK, jp, jcs, *_sweep_args(jp)[1:]),
            ti.pair_sweep(tspec, tgrid, BLOCK, tp, tcs, *_sweep_args(tp)[1:]))
    for ref in refs:
        for field in FIELDS:
            a = np.asarray(getattr(ref, field))
            b = getattr(out, field).numpy()
            scale = np.abs(a).max() + 1e-30
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * scale, err_msg=field)


def test_list_superset_under_skin():
    """tests/test_neighbor_list.py:test_list_superset_under_skin for the
    port: particles moved by up to h/2 after the build, the skinned list
    still holds every stencil pair within the H cutoff at the moved
    positions; and it is JAX's list."""
    (jspec, jgrid, jp, jcs), (tspec, tgrid, tp, tcs) = _port_inputs(2, 200, seed=9)
    kern = tspec.kernel
    nbr, _ = build_neighbor_list(kern, tgrid, CSEG, K, BLOCK, tp, tcs)
    j_nbr, _ = j_build(jspec.kernel, jgrid, CSEG, K=K, block_size=BLOCK,
                       particles=jp, cell_start=jcs)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(j_nbr))
    rng = np.random.default_rng(1)
    n = tp.capacity
    moved = tp.position.numpy() + rng.uniform(-1, 1, size=(n, 2)) * (kern.h / 2 / np.sqrt(2))
    nbr_np = nbr.numpy()
    cells = tp.cell.numpy()
    for i in range(0, n, 5):
        in_list = set(nbr_np[i][nbr_np[i] < n])
        for j in range(n):
            if j == i or np.max(np.abs(cells[j] - cells[i])) > 1:
                continue  # the reference's stencil gate
            d = np.linalg.norm(moved[i] - moved[j])
            if d * d <= kern.H2:
                assert j in in_list, f"pair ({i},{j}) missing from skinned list"


def test_the_chunk_and_a_short_list():
    """The list does not depend on ``block_size``; a K below the true count
    truncates each row to its K lowest indices and ``max_count`` says so."""
    _, (tspec, tgrid, tp, tcs) = _port_inputs(3, 150, seed=4)
    kern = tspec.kernel
    full, count = build_neighbor_list(kern, tgrid, CSEG, K, BLOCK, tp, tcs)
    odd, _ = build_neighbor_list(kern, tgrid, CSEG, K, 7, tp, tcs)
    assert torch.equal(full, odd)
    short, count_short = build_neighbor_list(kern, tgrid, CSEG, 16, BLOCK, tp, tcs)
    assert int(count_short) == int(count) > 16
    assert torch.equal(short, full[:, :16])
