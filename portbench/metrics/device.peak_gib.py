"""Peak device memory over set-up, window and traced sub-window
(``torch.cuda.max_memory_allocated``, the graph's pool included), in GiB."""


def read(obs):
    return obs["memory_peak_bytes"] / 2**30 if obs["memory_peak_bytes"] else None
