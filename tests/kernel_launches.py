"""Kernel launches as the card tests and ``chip_smoke.py`` count them.

While :func:`counting` is open, the port's kernel launchers are wrapped:
``ops/block_sweep.py:pack_fields``, the ``launch_pack`` of
``ops/block_sweep.py`` and of ``ops/cell_sweep.py``, and
``ops/mdbc_moments.py:_launch``.  After a launcher returns, its wrapper adds
the kernels it launched to an int64 counter on the launch's device, on the
current stream, with an atomic ``index_add_`` (the slabs of a sharded run on
one card are branches of one graph that run at once).  So an eager launch
adds at once, and a launch captured into a chunk graph adds from inside the
same graph, beside its kernel: every replay of a step adds, a step that its
IF node skips adds nothing, and a capture that fails adds nothing.  A graph
captured while counting holds one counter node beside each counted launch;
the port's own graphs hold none.  Reading the counts synchronises the card.

The counts (:data:`KINDS`): ``block`` / ``cell``, a sweep kernel launched
through a single-device entry; ``block_window`` / ``cell_window``, the same
kernels through a windowed entry (``sweep_sharded``, ``*_sweep_window``);
``pack``, the pack kernel (none for zero rows); ``mdbc`` and ``grouping``,
the moment kernel and the 4 grouping kernels of each mDBC call with slots.

On the CPU no kernel may run: :func:`forbid_kernels` makes
``ops/_build.load_library`` raise, so a CPU tensor that got past a wrapper's
plain branch fails the test.
"""

import sys
import threading
from contextlib import contextmanager

import torch

from sphexample_tpu_torch.ops import _build, block_sweep, cell_sweep, mdbc_moments

KINDS = ("block", "block_window", "cell", "cell_window", "pack", "mdbc", "grouping")

_lock = threading.Lock()
_counters: dict = {}     # device -> (int64 [len(KINDS)], index tensor per kind, {n: [n]})
_open = 0                # counting() blocks open
_originals: list = []


def kind(module) -> str:
    """"block" or "cell": the count of a sweep module's kernel."""
    return {block_sweep: "block", cell_sweep: "cell"}[module]


def arm(device: torch.device) -> None:
    """Make the counter of ``device`` (zeros) if it is not made yet: outside
    a capture, since one made during it would live in the graph's memory.
    :func:`counting` makes every card's; a CPU rehearsal makes the CPU's
    and counts its plain calls with :func:`add`."""
    if device not in _counters:
        _counters[device] = (
            torch.zeros(len(KINDS), dtype=torch.int64, device=device),
            [torch.tensor([i], device=device) for i in range(len(KINDS))],
            {n: torch.tensor([n], dtype=torch.int64, device=device) for n in (1, 4)})


def add(device, name: str, n: int) -> None:
    """Add ``n`` (1 or 4) to the count ``name`` of ``device``, on its current
    stream: the wrappers' add, for a test's own launch."""
    counter, index, value = _counters[torch.device(device)]
    counter.index_add_(0, index[KINDS.index(name)], value[n])


def _counted(fn):
    """Mark a wrapper: one that a test's monkeypatch put back after its
    counting() ended is not wrapped again, and counts only while counting."""
    fn.counted = True
    return fn


def _counted_pack(pack_fields):
    @_counted
    def pack(position, velocity, density, pressure, ml):
        out = pack_fields(position, velocity, density, pressure, ml)
        if _open and out.device.type == "cuda" and out.shape[0]:
            add(out.device, "pack", 1)
        return out
    return pack


def _counted_sweep(launch_pack, name: str):
    @_counted
    def launch(spec, grid, particles, cell_start, pack, self_off, dtype):
        out = launch_pack(spec, grid, particles, cell_start, pack, self_off, dtype)
        caller = sys._getframe(1)
        window = caller.f_code.co_name == "sweep_sharded" or (
            caller.f_code.co_name == "sweep_fields" and caller.f_locals["window"])
        if _open:
            add(pack.device, f"{name}_window" if window else name, 1)
        return out
    return launch


def _counted_mdbc(launch):
    @_counted
    def mdbc(spec, grid, B, *args, **kw):
        scratch = launch(spec, grid, B, *args, **kw)
        if _open and B > 0:
            add(scratch.device, "grouping", 4)
            add(scratch.device, "mdbc", 1)
        return scratch
    return mdbc


_WRAPPERS = ((block_sweep, "pack_fields", _counted_pack),
             (block_sweep, "launch_pack", lambda f: _counted_sweep(f, "block")),
             (cell_sweep, "launch_pack", lambda f: _counted_sweep(f, "cell")),
             (mdbc_moments, "_launch", _counted_mdbc))


@contextmanager
def counting():
    """Count the launches made inside the block (they can be nested).  The
    counters of every card are made here, before any capture."""
    global _open
    with _lock:
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            arm(torch.device("cuda", i))
        if _open == 0:
            for module, name, wrap in _WRAPPERS:
                fn = getattr(module, name)
                if not getattr(fn, "counted", False):
                    _originals.append((module, name, fn))
                    setattr(module, name, wrap(fn))
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                while _originals:
                    setattr(*_originals.pop())


def totals() -> dict:
    """Every count since the process began counting (synchronises the cards)."""
    out = dict.fromkeys(KINDS, 0)
    for device, (counter, _, _) in list(_counters.items()):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for name, v in zip(KINDS, counter.tolist()):
            out[name] += v
    return out


class Totals:
    """The counts since :meth:`reset` (since the process began counting
    before one), read live: ``launched.block``, ``launched["block"]``."""

    def __init__(self):
        self.base, self.end = dict.fromkeys(KINDS, 0), None

    def reset(self) -> None:
        self.base, self.end = totals(), None

    def __getitem__(self, name: str) -> int:
        return (self.end or totals())[name] - self.base[name]

    def __getattr__(self, name: str) -> int:
        if name not in KINDS:
            raise AttributeError(name)
        return self[name]


launched = Totals()


class Launches(Totals):
    """``with Launches() as n: ...``: counts the launches inside the block;
    ``n["block"]`` (or ``n.block``) reads live inside the block and as the
    count stood at its end after it."""

    def __enter__(self):
        self._counting = counting()
        self._counting.__enter__()
        self.reset()
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is None:
                self.end = totals()
        finally:
            self._counting.__exit__(*exc)
        return False


def forbid_kernels(monkeypatch) -> None:
    """Make every load of a kernel's library raise for the rest of the test."""
    def refuse(name):
        raise AssertionError(f"a CPU call reached the {name} kernel's library")

    monkeypatch.setattr(_build, "load_library", refuse)
