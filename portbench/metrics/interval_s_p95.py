"""The 95th percentile (nearest rank) of the wall time of every output
interval the window completed (host clock, from one output to the next)."""

from portbench.stats import percentile


def read(obs):
    walls = [r["wall_s"] for r in obs["intervals"]]
    return percentile(walls, 95) if walls else None
