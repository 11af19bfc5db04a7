#!/usr/bin/env python3
"""Time variants of the sweep kernels' shared walk on the card.

    python3 walk_variants.py                       # the variants below
    python3 walk_variants.py WALK_WARPS=2 WALK_WARPS=8 ...
    python3 walk_variants.py --reference DIR[,DIR...]  # DIR's sweep kernels, no variants
    python3 walk_variants.py --cells 51 --only dambreak3d.run,movingsquare.run ...

A variant is the committed sources with constants of
``sphexample_tpu_torch/csrc/sph_sweep_walk.cuh`` set to other values
(``NAME=VALUE[,NAME=VALUE]``), built with the flags of ``ops/_build.py`` into
``sphexample_tpu_torch/_build/variants/``; all builds run side by side.  Each
variant's block and cell kernels are launched through the wrappers on the
states chip_smoke.py drives - the main deck, the mDBC deck, the 2D moving
square and the 2,215,035-row dam break, each at t = 0 and stirred - whole and
as slab 1 of 4 (the windowed B2 / B3s), and timed alone (profiler, device
events only), in turns with the committed build (committed, variants...,
committed).  Every output must equal the committed build's bit for bit: a
variant changes the schedule, never the order of a self's sums.  With
``--reference DIR`` the sweep kernels of another checkout (same C
interface; several DIRs named by their last path part) run in the same turns
and are compared, not required to agree: with the committed kernel, and its
block kernel with the committed cell kernel, bit for bit and relative to each
field's max.  ``--cells S`` adds the benchmark cells' states
(``portbench/``): each deck run from its seeded arrays through the
benchmark's window for S seconds, as the harness runs it, and taken where the
window ends (``--seed N``, default 3180000001); ``--only A,B`` keeps the
states named.  Each state first prints the block schedule's pair bodies per
pass (ops/block_sweep.py:pass_bodies on 300 seeded passes: ``per_tile``,
``balanced``, ``cooperative_tiles``), for every WALK_TERM_BYTES a variant
sets.  One JSON line per state, kernel and build, then the card's name and
power limit.  Needs a GPU; exits 1 without one.
"""

import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
import time

from pathlib import Path

import torch

import chip_smoke as smoke
from sphexample_tpu_torch.ops import _build
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_sweep as cw

DEFAULT = ["WALK_WARPS=2", "WALK_WARPS=8"]
SOURCES = ("block_sweep", "cell_sweep")


def build_variant(spec, csrc=_build.CSRC, sources=SOURCES, name=None):
    """Start nvcc for ``sources`` of ``csrc`` with each ``NAME=VALUE`` of
    ``spec`` substituted; returns (name, {source: (process, library path)})."""
    name = name or spec.replace("=", "_").replace(",", "_")
    root = _build.BUILD / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(csrc, root / "csrc")
    hdr = root / "csrc" / "sph_sweep_walk.cuh"
    for item in filter(None, spec.split(",")):
        const, value = item.split("=")
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          hdr.read_text())
        if n != 1:
            raise SystemExit(f"walk_variants: no constant {const} in {hdr.name}")
        hdr.write_text(text)
    procs = {}
    for src in sources:
        lib = root / f"lib{src}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(root / "csrc" / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    return name, procs


def states(only=None):
    """(label, sim, particles, cell_start) of each path's state at t = 0,
    stirred (chip_smoke.stirred_state: seeded density and velocity noise, so
    that every branch of the pair physics is taken); those in ``only``."""
    for label, make in (("main", lambda: smoke.assemble(smoke.case_3d())),
                        ("mdbc", lambda: smoke.assemble_mdbc(smoke.case_3d())),
                        ("square", lambda: smoke.assemble_moving_square(
                            smoke.moving_square_case())),
                        ("large", lambda: smoke.assemble(smoke.case_3d(dx=smoke.LARGE_DX)))):
        if only and label not in only:
            continue
        sim = make()
        p, cs = smoke.stirred_state(sim)
        yield label, sim, p, cs
        del sim, p, cs
        torch.cuda.empty_cache()


def cell_states(seconds, seed, only=None):
    """(label, sim, particles, cell_start) of each benchmark cell where a
    window of ``seconds`` ends; those in ``only``."""
    from portbench import harness

    for name in ("dambreak3d.run", "movingsquare.run"):
        if only and name not in only:
            continue
        run = harness.Run(harness.cell(name), seed, torch.device("cuda:0"))
        run.setup(False)
        run.window(seconds)
        st = run.last_state
        yield name, run.sim, st.particles, st.cell_start
        del run, st
        torch.cuda.empty_cache()


def bodies(label, sim, p, cs, term_bytes):
    """The mirror's pair bodies per pass of the block schedule of this state
    (chip_smoke.schedule), for each WALK_TERM_BYTES a build sets."""
    k = bs.n_sums(sim.cfg.spec, sim.cfg.grid.dims)
    for tb in term_bytes:
        b = smoke.schedule(sim, p, cs, queue=max(tb // (4 * k), 8))["bodies"]
        print(json.dumps({"state": label, "walk_term_bytes": tb, "bodies": b}), flush=True)


def window(entry, p, slabs=4):
    """The windowed kernel ``entry`` (B2 / B3s) on the self rows of slab 1
    of ``slabs`` of the state, the whole state its extended rows; called
    with the single launch's arguments."""
    lo, hi = p.capacity // slabs, 2 * p.capacity // slabs

    def call(spec, grid, p, cs, position, density, pressure, velocity):
        return entry(spec, grid, p.map(lambda a: a[lo:hi]), cs, position, density, pressure,
                     velocity, p.motion_limiter, lo)

    call.window = [lo, hi]
    return call


def max_rel(a, b):
    """Largest difference of the sweep fields of ``a`` and ``b`` relative to
    each field's max in ``b``."""
    worst = 0.0
    for _, f in smoke.SWEEP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if y is not None:
            worst = max(worst, float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)))
    return worst


def bitwise(a, b):
    return all(getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f))
               for _, f in smoke.SWEEP_FIELDS)


def option(argv, name, kind, default=None):
    """(kind(VALUE), argv without ``name VALUE``), or (default, argv)."""
    if name not in argv:
        return default, argv
    k = argv.index(name)
    return kind(argv[k + 1]), argv[:k] + argv[k + 2:]


def main(argv):
    if not torch.cuda.is_available():
        print("walk_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    references, argv = option(argv, "--reference", lambda v: v.split(","), [])
    cells, argv = option(argv, "--cells", float)
    seed, argv = option(argv, "--seed", int, 3180000001)
    only, argv = option(argv, "--only", lambda v: set(v.split(",")))
    specs = argv or ([] if references else DEFAULT)
    term_bytes = [bs.WALK_TERM_BYTES] + sorted(
        {int(item.split("=")[1]) for spec in specs for item in spec.split(",")
         if item.startswith("WALK_TERM_BYTES=")} - {bs.WALK_TERM_BYTES})
    _build.build_all(SOURCES)
    builds = dict(build_variant(s) for s in specs)
    refs = {("reference" if len(references) == 1 else Path(r).name): r for r in references}
    for name, r in refs.items():
        builds.update([build_variant("", Path(r) / "sphexample_tpu_torch" / "csrc", SOURCES,
                                     name)])
    libs = {"committed": {s: _build.load_library(s) for s in SOURCES}}
    for name, procs in builds.items():
        libs[name] = {}
        for src, (proc, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"walk_variants: nvcc failed for {name}/{src}:\n{log}")
            lib = ctypes.CDLL(str(path))
            _build._declare(src, lib)
            libs[name][src] = lib
            regs = smoke.ptxas_report(log)
            print(json.dumps({"build": name, "source": src, "ptxas": regs}), flush=True)
    every = states(only)
    if cells is not None:
        every = itertools.chain(every, cell_states(cells, seed, only))
    for label, sim, p, cs in every:
        bodies(label, sim, p, cs, term_bytes)
        args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density, p.pressure,
                p.velocity)
        outs = {}
        for src, call in (("block_sweep", bs.block_sweep), ("cell_sweep", cw.cell_sweep),
                          ("block_sweep", window(bs.block_sweep_window, p)),
                          ("cell_sweep", window(cw.cell_sweep_window, p))):
            order = ["committed", *(b for b in builds if src in libs[b]), "committed"]
            for k, name in enumerate(order):
                _build._libs[src] = libs[name][src]
                out = call(*args)
                torch.cuda.synchronize()
                outs.setdefault((call, name), out)
                ref = outs[(call, "committed")]
                rec = {"state": label, "n": int(p.active.sum()), "kernel": src,
                       "window": getattr(call, "window", None), "build": name,
                       "turn": k, "kernel_only_ms": smoke.kernel_only_ms(lambda: call(*args),
                                                                         src, reps=10),
                       "bitwise_committed": bitwise(out, ref)}
                if name in refs:
                    rec["max_rel_vs_committed"] = max_rel(out, ref)
                print(json.dumps(rec), flush=True)
                if not rec["bitwise_committed"] and name not in refs:
                    raise SystemExit(f"walk_variants: {name} changed the bits of {src} "
                                     f"on the {label} state")
            _build._libs[src] = libs["committed"][src]
        cell = outs[(cw.cell_sweep, "committed")]
        summary = {"state": label, "block_vs_cell_bitwise": bitwise(
            outs[(bs.block_sweep, "committed")], cell)}
        for name in refs:
            summary[name] = {"block_vs_cell_bitwise": bitwise(outs[(bs.block_sweep, name)], cell),
                             "block_vs_cell_max_rel": max_rel(outs[(bs.block_sweep, name)], cell)}
        print(json.dumps(summary), flush=True)
        del sim, p, cs, args, outs, cell
    print(json.dumps({"elapsed_s": time.perf_counter() - t0}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
