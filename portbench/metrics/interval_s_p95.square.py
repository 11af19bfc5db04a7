"""``interval_s_p95``, read in the moving square's cell (latency-bound: its host-dependent spread is 4x the dam break's, so it carries a bound of its own)."""

from portbench.harness import find, load_module

read = load_module(find("metrics", "interval_s_p95", ".py")).read
