"""Runnable examples of the port (counterparts of the repo's ``examples/``),
each a module: ``python -m repro_torch.examples.<name>``."""
