"""``particle_steps_per_s``, read in the moving square's cell (latency-bound: its host-dependent spread is 4x the dam break's, so it carries a bound of its own)."""

from portbench.harness import find, load_module

read = load_module(find("metrics", "particle_steps_per_s", ".py")).read
