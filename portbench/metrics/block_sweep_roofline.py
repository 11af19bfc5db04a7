"""B1's share of its roofline, in %: the least time one sweep of the traced
state could take on the card (``work.py``: the larger of the operations over
the f32 peak and the bytes over the HBM peak) over B1's device time per
launch in the traced sub-window.  Nothing where the cell's sweep is not B1
or no launch was timed."""


def read(obs):
    t, w = obs["trace"], obs["work"]
    if t is None or w is None or not t.get("b1_s_per_launch"):
        return None
    return 100.0 * w["bound_s"] / t["b1_s_per_launch"]
