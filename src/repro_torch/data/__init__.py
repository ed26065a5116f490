"""Deterministic synthetic data of the port (numpy, copied from
``src/repro/data``)."""
