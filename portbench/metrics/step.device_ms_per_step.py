"""Device milliseconds per step: the union of device activity in the traced
sub-window (torch.profiler) over its steps."""


def read(obs):
    t = obs["trace"]
    if t is None or not t["steps"] or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
