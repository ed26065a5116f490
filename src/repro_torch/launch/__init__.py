"""Serving entry points of the port (``repro.launch``): the serving
driver (``serve_bridges``: batched, single, incremental, churn,
multitenant, ingest and failover workloads) and the failover drill it
runs (``failover``)."""
