"""The deck CLIs (port of the repository's ``examples/``): one module per
case, each run as ``python -m sphexample_tpu_torch.examples.<deck>`` - on the
card by default, on the CPU with ``--cpu``.  ``_runner`` holds the flags and
the run that all six share."""
