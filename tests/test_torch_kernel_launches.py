"""The launch counts of ``tests/kernel_launches.py``, which the card tests
and ``chip_smoke.py`` read, on the CPU: each wrapped launcher (here over a
stand-in that launches nothing, with its counter on the CPU) adds to its
count while counting is open, a sweep launch to the windowed count when a
windowed entry made it, and a wrapper that a monkeypatch put back is neither
wrapped again nor counting once counting ended."""

import pytest
import torch

import kernel_launches as K
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import mdbc_moments as mm

CPU = torch.device("cpu")


@pytest.fixture
def stand_ins(monkeypatch):
    """Launchers that launch nothing and return a CPU tensor, a CPU counter."""
    K.arm(CPU)
    out = torch.zeros(3, 4)
    for mod in (bs, cw):
        monkeypatch.setattr(mod, "launch_pack", lambda *a: out)
    monkeypatch.setattr(mm, "_launch", lambda spec, grid, B, *a: out)
    monkeypatch.setattr(bs, "pack_fields", lambda *a: out)
    yield out
    K._counters.pop(CPU)


def sweep_fields(launch, window):
    """Calls ``launch`` as ``ops/block_sweep.py:sweep_fields`` does."""
    return launch(None, None, None, None, torch.zeros(2, 12), 0, torch.float32)


def sweep_sharded(launch):
    """Calls ``launch`` as ``ops/block_sweep.py:sweep_sharded`` does."""
    return launch(None, None, None, None, torch.zeros(2, 12), 0, torch.float32)


@pytest.mark.parametrize("mod", [bs, cw])
@pytest.mark.parametrize("entry", ["single", "window", "sharded"])
def test_a_sweep_launch_counts_by_its_entry(stand_ins, mod, entry):
    name = K.kind(mod)
    with K.Launches() as n:
        for _ in range(3):
            if entry == "sharded":
                sweep_sharded(mod.launch_pack)
            else:
                sweep_fields(mod.launch_pack, entry == "window")
    counts = {k: n[k] for k in K.KINDS}
    want = dict.fromkeys(K.KINDS, 0)
    want[name if entry == "single" else f"{name}_window"] = 3
    assert counts == want


@pytest.mark.parametrize("slots", [0, 5])
def test_an_mdbc_call_counts_its_five_kernels_when_it_has_slots(stand_ins, slots):
    with K.Launches() as n:
        mm._launch(None, None, slots)
        mm._launch(None, None, slots)
    assert (n.mdbc, n.grouping) == ((2, 8) if slots else (0, 0))
    assert n.block == n.pack == 0


def test_a_cpu_pack_counts_nothing_and_counting_ends(stand_ins):
    with K.Launches() as n:
        bs.pack_fields(None, None, None, None, None)
        assert getattr(bs.launch_pack, "counted", False)
    assert n.pack == 0
    assert not getattr(bs.launch_pack, "counted", False)      # the stand-in again


def test_a_wrapper_put_back_is_not_wrapped_again(stand_ins):
    patch = pytest.MonkeyPatch()
    with K.counting():
        wrapped = bs.launch_pack
        patch.setattr(bs, "launch_pack", wrapped)          # saves the wrapper
    patch.undo()                                           # puts it back
    assert bs.launch_pack is wrapped
    base = K.totals()["block"]
    sweep_fields(bs.launch_pack, False)                    # counting closed
    with K.Launches() as n:
        assert bs.launch_pack is wrapped
        sweep_fields(bs.launch_pack, False)
    assert K.totals()["block"] - base == n.block == 1
