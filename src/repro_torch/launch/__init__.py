"""Serving entry points of the port (``repro.launch``): the failover drill."""
