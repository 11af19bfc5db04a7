"""``block_sweep_roofline``, read in the moving square's cell, where it moves that cell's own rate (``particle_steps_per_s.square``)."""

from portbench.harness import find, load_module

read = load_module(find("metrics", "block_sweep_roofline", ".py")).read
