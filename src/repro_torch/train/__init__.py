"""Training utilities of the port (so far: the optimizer; port of ``repro.train``)."""
