"""Particle-steps per second: active particles times the steps of every
output interval the window completed, over the window's wall (host clock),
restarts included."""


def read(obs):
    if obs["window_s"] <= 0 or not obs["steps"]:
        return None
    return obs["n_live"] * obs["steps"] / obs["window_s"]
