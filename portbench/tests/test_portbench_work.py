"""The sweep's work count (the roofline's yardstick) counts the pairs the
physics needs whatever order the rows are in: on a coarse state it gives the
pairs the port's plain sweep accepts right after a rebuild, and the same
pairs, approaching pairs and bytes for a shuffled copy of the rows."""

import pytest
import torch

from portbench import harness, work
from portbench.reference import sph
from portbench.tests.coarse import coarse_cell


def _port_pairs(sim, state):
    """Pairs the port's plain sweep keeps on ``state`` after a rebuild."""
    from sphexample_tpu_torch.ops import cell_list as cl
    from sphexample_tpu_torch.ops.interactions import candidates

    kern = sim.cfg.spec.kernel
    p, cs, _ = cl.rebuild(state.particles, kern.H_inv, sim.cfg.grid)
    starts, ends = cl.row_segments(p.cell, sim.cfg.grid, cs)
    i, j = candidates(starts, ends, 0, p.capacity)
    xij = p.position[i] - p.position[j]
    keep = ((xij * xij).sum(-1) <= kern.H2) & (i != j)
    vdotx = ((p.velocity[i] - p.velocity[j]) * xij).sum(-1)
    return int(keep.sum()), int((keep & (vdotx < 0)).sum())


@pytest.mark.parametrize("workload", ["dambreak3d.run", "movingsquare.run"])
def test_pairs_and_bytes_independent_of_row_order(workload):
    c = coarse_cell(workload)
    cfg = c["config"]
    arrays = harness.deck_arrays(cfg, 11)
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    state = sim.interval_fn(sim.state, 0.004)          # moving, sorted by the port
    p = state.particles
    P = sph.physics(cfg)
    grid = sph.Grid.around(arrays[0], P)
    got = work.sweep_work(cfg, P, grid, p.position, p.velocity)
    assert (got["pairs"], got["approaching_pairs"]) == _port_pairs(sim, state)
    assert got["pairs"] > 0 and got["approaching_pairs"] > 0
    perm = torch.randperm(p.capacity, generator=torch.Generator().manual_seed(3))
    shuffled = work.sweep_work(cfg, P, grid, p.position[perm], p.velocity[perm])
    assert shuffled == got
    n, d = p.position.shape
    assert got["bytes"] == n * (2 * d + 3) * 4 + n * work.sums_per_row(cfg) * 4
    per_pair, per_approach = work.OPS_PER_PAIR[work.model_key(cfg)]
    assert got["ops"] == per_pair * got["pairs"] + per_approach * got["approaching_pairs"]
