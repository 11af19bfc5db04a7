"""The distributed rebuild of the port (``ops/cell_list.rebuild_sharded``:
local stable sort + 1-hop row migration) and the replicated-argsort
``rebuild(ctx)``, on 4 thread ranks with CPU tensors, against

* the JAX package's ``rebuild_sharded`` under ``shard_map`` on 4 virtual CPU
  devices, on the same displaced tall column with real migration (the set-up
  of tests/test_sharded.py:292-352): slab ``id``, ``cell``, every other
  field, ``cell_start``, the occupancy and ``migration_need`` bit for bit;
* the port's own single-device ``rebuild`` on the gathered state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import sphexample_tpu_torch as T
from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.parallel.mesh import AXIS, _particle_specs
from sphexample_tpu.parallel.mesh import make_mesh as j_make_mesh
from sphexample_tpu.parallel.mesh import shard_simulation as j_shard
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.parallel.context import CommContext, LocalGroup, run_ranks
from test_sharded import _tall_column_setup

torch.set_num_threads(1)
N = 4


def _port_particles(pj) -> T.Particles:
    return T.Particles(**{f.name: torch.tensor(np.asarray(getattr(pj, f.name)))
                          for f in dataclasses.fields(T.Particles)})


def _slabs(p: T.Particles):
    C = p.capacity // N
    return [p.map(lambda a, r=r: a[r * C:(r + 1) * C].clone()) for r in range(N)]


def _on_ranks(fn):
    group = LocalGroup(["cpu"] * N, timeout=60.0)
    return run_ranks(group, lambda r: fn(CommContext(group, r), r))


@pytest.fixture(scope="module")
def displaced():
    """The JAX sharded tall column with every fluid particle moved 0.6 cell
    pitches up, its JAX distributed rebuild, and the port's copy of the
    displaced particles."""
    mesh = j_make_mesh(N)
    sim = j_shard(_tall_column_setup(use_pallas=True), mesh)
    cfg = sim.cfg
    assert cfg.halo > 0
    kern = cfg.spec.kernel
    pitch = 1.0 / kern.H_inv
    p = sim.state.particles
    dz = jnp.where(p.ptype == 1, 0.6 * pitch, 0.0)
    p = p.replace(position=p.position.at[:, -1].add(dz * p.active))
    fn = jax.jit(shard_map(
        lambda q: jcl.rebuild_sharded(q, kern.H_inv, cfg.grid, cfg.ctx, cfg.halo),
        mesh=mesh, in_specs=(_particle_specs(AXIS),),
        out_specs=(_particle_specs(AXIS), P(), P(), P()), check_vma=False))
    merged, cs, occ, mig = fn(p)
    grid = cl.Grid(cmin=tuple(cfg.grid.cmin), shape=tuple(cfg.grid.shape))
    return dict(jax=(merged, np.asarray(cs), int(occ), int(mig)), halo=int(cfg.halo),
                H_inv=kern.H_inv, grid=grid, particles=_port_particles(jax.device_get(p)))


def test_rebuild_sharded_matches_jax_bitwise(displaced):
    merged_j, cs_j, occ_j, mig_j = displaced["jax"]
    assert 0 < mig_j <= displaced["halo"]       # rows really crossed slab edges
    slabs = _slabs(displaced["particles"])
    out = _on_ranks(lambda c, r: cl.rebuild_sharded(
        slabs[r], displaced["H_inv"], displaced["grid"], c, displaced["halo"]))
    C = slabs[0].capacity
    for r, (p, cs, occ, mig) in enumerate(out):
        np.testing.assert_array_equal(cs.numpy(), cs_j)
        assert cs.dtype == torch.int32
        assert int(occ) == occ_j and int(mig) == mig_j
        for f in dataclasses.fields(T.Particles):
            want = np.asarray(getattr(merged_j, f.name))[r * C:(r + 1) * C]
            got = getattr(p, f.name).numpy()
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f"{f.name} of slab {r}")


def test_rebuild_sharded_matches_single_device_rebuild(displaced):
    p = displaced["particles"]
    ref, cs_ref, occ_ref = cl.rebuild(p, displaced["H_inv"], displaced["grid"])
    assert int((ref.id != p.id).sum()) > 0      # the displacement reordered rows
    slabs = _slabs(p)
    out = _on_ranks(lambda c, r: cl.rebuild_sharded(
        slabs[r], displaced["H_inv"], displaced["grid"], c, displaced["halo"]))
    for f in dataclasses.fields(T.Particles):
        got = torch.cat([o[0].__dict__[f.name] for o in out])
        assert torch.equal(got, getattr(ref, f.name)), f.name
    for _, cs, occ, _ in out:
        assert torch.equal(cs, cs_ref) and int(occ) == int(occ_ref)


def test_replicated_rebuild_matches_single_device_rebuild(displaced):
    """``rebuild(ctx)``: gathered keys, the same global argsort on every rank,
    each rank's slab of the sorted order (the path ``halo == 0`` takes)."""
    p = displaced["particles"]
    ref, cs_ref, occ_ref = cl.rebuild(p, displaced["H_inv"], displaced["grid"])
    slabs = _slabs(p)
    out = _on_ranks(lambda c, r: cl.rebuild(slabs[r], displaced["H_inv"],
                                            displaced["grid"], c))
    for f in dataclasses.fields(T.Particles):
        got = torch.cat([getattr(o[0], f.name) for o in out])
        assert torch.equal(got, getattr(ref, f.name)), f.name
    for _, cs, occ in out:
        assert torch.equal(cs, cs_ref) and int(occ) == int(occ_ref)


def test_rows_beyond_one_hop_are_counted_not_hidden(displaced):
    """A halo smaller than the migration: ``migration_need`` still reports the
    true need (the guard compares it with the halo), though the merge can no
    longer be right."""
    p = displaced["particles"]
    slabs = _slabs(p)
    need = displaced["jax"][3]
    small = max(1, need // 2)
    out = _on_ranks(lambda c, r: cl.rebuild_sharded(
        slabs[r], displaced["H_inv"], displaced["grid"], c, small))
    assert all(int(o[3]) == need for o in out) and need > small
