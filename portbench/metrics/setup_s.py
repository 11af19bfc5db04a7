"""Set-up: from the process's start to the window's (imports, the card,
the kernels' build or load, the deck's arrays, assembly, the chunk graph's
capture by a warm interval)."""


def read(obs):
    return obs["setup_s"]
