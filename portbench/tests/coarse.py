"""Coarse copies of the benchmark's cells for the CPU tests: the same decks,
models and limits at a spacing a test run can hold."""

import math

from portbench import harness


def coarse_cell(workload: str) -> dict:
    c = harness.cell(workload)
    cfg = c["config"]
    if cfg["deck"] == "dam_break_3d":
        dx = 0.05
        cfg["geometry"]["dx"] = dx
        cfg["constants"].update(dx=dx, m0=1000 * dx**3)
        cfg["kernel"]["h"] = math.sqrt(3) * dx
    else:
        dx = 0.1
        cfg["geometry"].update(dp=dx, box=[3.0, 1.5], centre=[1.0, 0.75], side=0.4)
        cfg["constants"]["dx"] = dx
        cfg["kernel"]["dx"] = dx
    cfg["check"]["later"] = [2, 3]
    return c
