"""Training loop of the port (counterpart of `repro.train`)."""
