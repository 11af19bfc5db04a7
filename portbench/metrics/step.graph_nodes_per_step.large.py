"""``step.graph_nodes_per_step``, read in the 2.2M-row dam break's cell, where the sweep is B3 (``particle_steps_per_s``)."""

from portbench.harness import find, load_module

read = load_module(find("metrics", "step.graph_nodes_per_step", ".py")).read
