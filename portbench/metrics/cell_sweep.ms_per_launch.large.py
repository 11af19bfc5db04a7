"""B3's device milliseconds per launch in the traced sub-window: the time of
the device operations named ``cell_sweep_kernel`` or
``occupied_groups_kernel`` (the two kernels of one cell-sweep call) among
those the trace lists, over the sweep's two calls a step.  Nothing where the
trace lists no such operation (the cell's sweep is not B3)."""

NAMES = ("cell_sweep_kernel", "occupied_groups_kernel")


def read(obs):
    t = obs["trace"]
    if t is None or not t.get("steps"):
        return None
    mine = [s for name, s in t.get("device_ops", ()) if any(k in name for k in NAMES)]
    if not mine:
        return None
    return 1e3 * sum(mine) / (2 * t["steps"])
