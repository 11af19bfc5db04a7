"""The plain reference: the SPH step in plain PyTorch, from a configuration file alone."""
