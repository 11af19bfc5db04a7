"""Nodes of the chunk graph per step (``ChunkGraph.nodes_per_step``: the
step's three captured pieces, two set kernels and two IF nodes)."""


def read(obs):
    return obs["graph_nodes_per_step"]
