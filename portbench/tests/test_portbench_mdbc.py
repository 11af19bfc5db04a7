"""Decks with ghost nodes in the harness, on the CPU without JAX or CUDA:

* the plain reference's SIMPLE mDBC against the port's plain CPU mDBC path
  (``ops/mdbc.py``) in float64 on a coarse copy of the three-layer mDBC dam
  break, in the first interval and in a later one from the program's own
  state in its row order, boundary densities included;
* the program assembled without mDBC fails the comparison on that deck;
* the deck is ``chip_smoke.py:mdbc_dam_break``'s, bit for bit;
* the decks without ghost nodes give the bits they gave before ghost nodes
  were taken in (frozen digests of ``deck_arrays`` and of the reference);
* mDBC's work count against a brute-force count;
* the trace's reduction totals the mDBC kernels' device time and launches.
"""

import copy
import hashlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import check, harness, trace, work
from portbench.reference import sph
from portbench.tests.coarse import coarse_cell

SEED = 2**31 + 99
# the rho_gap limit proposed for the mDBC dam break's configuration, from
# the program's, the float32 witness's and the bfloat16 control's readings
# on the card (PERF.md)
RHO_GAP_LIMIT = 0.01


def mdbc_config(mdbc="simple", dtype="float64"):
    """The dam break's coarse copy (dx 0.05) with three-layer mDBC walls."""
    cfg = coarse_cell("dambreak3d.run")["config"]
    cfg.update(name="dambreak3d_mdbc", deck="dam_break_3d_mdbc")
    cfg["geometry"]["wall_layers"] = 3
    cfg["models"]["mdbc"] = mdbc
    cfg["run"]["dtype"] = dtype
    return cfg


def intervals(cfg, arrays, which, ref_cfg=None, t1=0.003, t2=0.006):
    """(program's end state, reference's end state, program's steps,
    reference's steps) of the ``first`` interval [0, t1] or the ``later``
    one [t1, t2], the reference (configured by ``ref_cfg``, else ``cfg``)
    starting from the program's state at t1."""
    ref_cfg = ref_cfg or cfg
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    mid = sim.interval_fn(sim.state, t1)
    if which == "first":
        ref, steps = check.reference_interval(ref_cfg, arrays, None, t1, 1000, device="cpu")
        return check.port_numpy(mid), ref, int(mid.iteration), steps
    end = sim.interval_fn(mid, t2)
    start = dict(check.port_numpy(mid), order=mid.particles.id.long().numpy() - 1)
    ref, steps = check.reference_interval(ref_cfg, arrays, start, t2, 1000, device="cpu")
    return check.port_numpy(end), ref, int(end.iteration) - int(mid.iteration), steps


@pytest.mark.parametrize("which", ["first", "later"])
def test_reference_mdbc_matches_the_ports_plain_path(which):
    cfg = mdbc_config()
    arrays = harness.deck_arrays(cfg, SEED)
    assert len(arrays) == 7
    got, ref, steps, ref_steps = intervals(cfg, arrays, which)
    assert steps == ref_steps >= 5
    gaps = check.gaps(got, ref, steps, ref_steps, sph.physics(cfg))
    assert gaps["steps"] == 0
    for field in ("pos_gap", "vel_gap", "rho_gap"):
        assert gaps[field] < 1e-9, (field, gaps)
    # the wall rows (ids 1..nb) were corrected, and agree
    nb = len(arrays[5])
    wall = got["density"][:nb]
    assert (wall != 1000.0).sum() > 100
    assert np.abs(wall - ref["density"][:nb]).max() < 1e-9 * np.abs(wall - 1000.0).max()


@pytest.mark.parametrize("which", ["first", "later"])
def test_the_comparison_sees_a_program_without_mdbc(which):
    cfg = mdbc_config()
    arrays = harness.deck_arrays(cfg, SEED)
    plain = mdbc_config("none")
    sim = harness.build_port(plain, arrays, torch.device("cpu"))
    assert int(torch.any(sim.state.particles.ghost_points != 0)) == 0
    # the reference with the deck's ghosts, from the same start
    got, ref, steps, ref_steps = intervals(plain, arrays, which, ref_cfg=cfg)
    gaps = check.gaps(got, ref, steps, ref_steps, sph.physics(cfg))
    assert gaps["rho_gap"] > RHO_GAP_LIMIT, gaps


@pytest.mark.parametrize("dx", [0.05, 0.03])
def test_deck_is_chip_smokes_mdbc_dam_break(dx):
    import chip_smoke

    arrays, ghost, normals, meta, _, _ = chip_smoke.mdbc_dam_break(chip_smoke.case_3d(dx))
    geometry = dict(coarse_cell("dambreak3d.run")["config"]["geometry"], dx=dx, wall_layers=3)
    deck = harness.load_module(harness.find("decks", "dam_break_3d_mdbc", ".py"))
    built = deck.build(geometry)
    want = (*arrays, ghost, normals)
    assert len(built) == len(want) == 7
    for a, b in zip(built, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert meta.mdbc.value == "simple"


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# deck_arrays, the reference's first interval and a later one from a
# shuffled copy of it, before decks could carry ghost nodes
DIGESTS = {
    "dambreak3d.run": (0.002, 0.004, "5700760d645c0799", 4, "4dd8e37b2a9310be", 4,
                       "addf0cb09933ab58"),
    "movingsquare.run": (0.02, 0.04, "298beda56acb7921", 20, "74c7439e2c3016c4", 20,
                         "0f9be1ea6ffb4303"),
}


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_decks_without_ghosts_keep_their_bits(workload):
    t1, t2, *want = DIGESTS[workload]
    cfg = coarse_cell(workload)["config"]
    arrays = harness.deck_arrays(cfg, 2**31 + 7)
    ref1, steps1 = check.reference_interval(cfg, arrays, None, t1, 1000, device="cpu")
    perm = np.random.default_rng(5).permutation(len(ref1["id"]))
    start = dict(ref1, acceleration=np.zeros_like(ref1["position"]), order=perm)
    ref2, steps2 = check.reference_interval(cfg, arrays, start, t2, 1000, device="cpu")

    def fields(r):
        return r["id"], r["position"], r["velocity"], r["density"], np.array([r["total_time"]])

    assert len(arrays) == 5
    assert [_digest(*arrays), steps1, _digest(*fields(ref1)), steps2,
            _digest(*fields(ref2))] == want


def _brute(P, position, ghost, fluid):
    has = ghost.abs().sum(-1) > 0
    d = ghost[has][:, None, :] - position[fluid][None, :, :]
    within = (d * d).sum(-1) <= P.H2
    return int(within.sum()), int(within.any(1).sum()), int(within.any(0).sum())


@pytest.mark.parametrize("dims", [2, 3])
def test_mdbc_pairs_match_a_brute_force_count(dims):
    g = torch.Generator().manual_seed(dims)
    P = SimpleNamespace(H=0.1, H2=0.1**2)
    n = 400
    position = (torch.rand(n, dims, generator=g) * 0.6 - 0.1).to(torch.float32)
    fluid = torch.rand(n, generator=g) < 0.6
    ghost = torch.zeros(n, dims)
    walls = ~fluid & (torch.rand(n, generator=g) < 0.8)
    ghost[walls] = position[walls] + 0.05 * torch.randn(int(walls.sum()), dims, generator=g)
    got = work.count_ghost_pairs(P, position, ghost, fluid, per_slice=997)
    assert got == _brute(P, position, ghost, fluid)
    assert got[0] > 100
    cfg = {"kernel": {"dims": dims}}
    w = work.mdbc_work(cfg, P, position, ghost, torch.where(fluid, 1, 2))
    pairs, wet, reached = got
    assert w["ops"] == (work.MDBC_OPS_PER_PAIR[dims] * pairs
                        + work.MDBC_OPS_PER_GHOST[dims] * wet)
    assert w["bytes"] == wet * (2 * dims + 2) * 4 + reached * (dims + 2) * 4
    assert w["bound_s"] > 0


def test_mdbc_work_of_a_program_state_takes_the_decks_ghosts():
    cfg = mdbc_config(dtype="float32")
    arrays = harness.deck_arrays(cfg, SEED)
    sim = harness.build_port(cfg, arrays, torch.device("cpu"))
    state = sim.interval_fn(sim.state, 0.003)          # rows in the program's order
    run = SimpleNamespace(config=cfg, arrays=arrays)
    got = harness.state_mdbc_work(run, state)
    p = state.particles
    assert (got["pairs"], got["wet_ghosts"], got["fluid_rows"]) == _brute(
        sph.physics(cfg), p.position, p.ghost_points, p.ptype == 1)
    assert 0 < got["wet_ghosts"] < len(arrays[5])


def _event(name, a, b, device="CUDA"):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=f"DeviceType.{device}", is_user_annotation=False)


MDBC_KERNELS = ["void (anonymous namespace)::mdbc_wet_group_kernel<3>(MdbcParams)",
                "void (anonymous namespace)::mdbc_keys_group_kernel<3, float>(MdbcParams)",
                "void (anonymous namespace)::mdbc_cells_group_kernel<3>(MdbcParams)",
                "void (anonymous namespace)::mdbc_order_group_kernel<3>(MdbcParams)",
                "void (anonymous namespace)::mdbc_moments_kernel<3, float, true>(MdbcParams)"]


@pytest.mark.parametrize("groups", [{"mdbc": harness.MDBC_OPS}, None])
def test_trace_totals_the_mdbc_kernels(groups):
    events = [_event("marker", 0.0, 10.0)]
    t = 10.0
    for step in range(3):                   # 3 steps: B4 and its grouping, then B1
        for k, name in enumerate(MDBC_KERNELS):
            events.append(_event(name, t, t + 2.0 + 10.0 * (k == 4)))
            t += 20.0
        events.append(_event("block_sweep_kernel<3>", t, t + 50.0))
        t += 60.0
    events.append(_event("marker", t, t + 5.0))
    red = trace.reduce(events, groups=groups)
    assert red["kernel_launches"] == 3 and red["kernel_s"] == pytest.approx(150e-6)
    if groups is None:
        assert not any(k.startswith("mdbc") for k in red)
        return
    assert red["mdbc_launches"] == 15
    assert red["mdbc_s"] == pytest.approx(3 * (5 * 2.0 + 10.0) * 1e-6)
    assert math.isclose(sum(s for name, s in red["device_ops"] if "mdbc_" in name),
                        red["mdbc_s"])


def test_physics_takes_simple_mdbc_only():
    cfg = mdbc_config()
    assert sph.physics(cfg).mdbc is True
    assert sph.physics(mdbc_config("none")).mdbc is False
    bad = copy.deepcopy(cfg)
    bad["models"]["mdbc"] = "full"
    with pytest.raises(NotImplementedError):
        sph.physics(bad)
