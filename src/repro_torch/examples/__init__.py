"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
one for each of the JAX package's single-device ``examples/*.py``."""
