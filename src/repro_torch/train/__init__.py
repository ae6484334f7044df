"""Training loop of the port (port of ``repro.train``)."""
