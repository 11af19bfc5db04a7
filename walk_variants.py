#!/usr/bin/env python3
"""Time variants of the sweep kernels' shared walk on the card.

    python3 walk_variants.py                       # the variants below
    python3 walk_variants.py WALK_WARPS=2 WALK_WARPS=8 ...
    python3 walk_variants.py --reference DIR       # and DIR's block kernel

A variant is the committed sources with constants of
``sphexample_tpu_torch/csrc/sph_sweep_walk.cuh`` set to other values
(``NAME=VALUE[,NAME=VALUE]``), built with the flags of ``ops/_build.py`` into
``sphexample_tpu_torch/_build/variants/``; all builds run side by side.  Each
variant's block and cell kernels are launched through the wrappers on the
states chip_smoke.py drives - the main deck, the mDBC deck, the 2D moving
square and the 2,215,035-row dam break, each at t = 0 and stirred - and timed
alone (profiler, device events only), in turns with the committed build
(committed, variants..., committed).  Every output must equal the committed
build's bit for bit: a variant changes the schedule, never the order of a
self's sums.  With ``--reference DIR`` the block kernel of another checkout
(same C interface) runs in the same turns and is compared, not required to
agree: with the committed block kernel and with the committed cell kernel, bit
for bit and relative to each field's max.  One JSON line per state, kernel
and build, then the card's name and power limit.  Needs a GPU; exits 1
without one.
"""

import ctypes
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


def states():
    """(label, sim, particles, cell_start) of each path's state at t = 0,
    stirred (chip_smoke.stirred_state: seeded density and velocity noise, so
    that every branch of the pair physics is taken)."""
    for label, make in (("main", lambda: smoke.assemble(smoke.case_3d())),
                        ("mdbc", lambda: smoke.assemble_mdbc(smoke.case_3d())),
                        ("square", lambda: smoke.assemble_moving_square(
                            smoke.moving_square_case())),
                        ("large", lambda: smoke.assemble(smoke.case_3d(dx=smoke.LARGE_DX)))):
        sim = make()
        p, cs = smoke.stirred_state(sim)
        yield label, sim, p, cs
        del sim, p, cs
        torch.cuda.empty_cache()


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


def main(argv):
    if not torch.cuda.is_available():
        print("walk_variants: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    reference = None
    if "--reference" in argv:
        k = argv.index("--reference")
        reference = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    specs = argv or DEFAULT
    _build.build_all(SOURCES)
    builds = dict(build_variant(s) for s in specs)
    if reference:
        builds.update([build_variant("", Path(reference) / "sphexample_tpu_torch" / "csrc",
                                     ("block_sweep",), "reference")])
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
    for label, sim, p, cs in states():
        args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density, p.pressure,
                p.velocity)
        outs = {}
        for src, call in (("block_sweep", bs.block_sweep), ("cell_sweep", cw.cell_sweep)):
            order = ["committed", *(b for b in builds if src in libs[b]), "committed"]
            for k, name in enumerate(order):
                _build._libs[src] = libs[name][src]
                out = call(*args)
                torch.cuda.synchronize()
                outs.setdefault((src, name), out)
                ref = outs[(src, "committed")]
                rec = {"state": label, "n": int(p.active.sum()), "kernel": src, "build": name,
                       "turn": k, "kernel_only_ms": smoke.kernel_only_ms(lambda: call(*args),
                                                                         src, reps=10),
                       "bitwise_committed": bitwise(out, ref)}
                if name == "reference":
                    rec["max_rel_vs_committed"] = max_rel(out, ref)
                print(json.dumps(rec), flush=True)
                if not rec["bitwise_committed"] and name != "reference":
                    raise SystemExit(f"walk_variants: {name} changed the bits of {src} "
                                     f"on the {label} state")
            _build._libs[src] = libs["committed"][src]
        cell = outs[("cell_sweep", "committed")]
        summary = {"state": label, "block_vs_cell_bitwise": bitwise(
            outs[("block_sweep", "committed")], cell)}
        if reference:
            summary.update(reference_block_vs_cell_bitwise=bitwise(
                outs[("block_sweep", "reference")], cell),
                reference_block_vs_cell_max_rel=max_rel(outs[("block_sweep", "reference")], cell))
        print(json.dumps(summary), flush=True)
        del sim, p, cs, args, outs, cell
    print(json.dumps({"elapsed_s": time.perf_counter() - t0}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
