"""Serving entry points of the port (``repro.launch``): the serving
driver (``serve_bridges``: batched, single, incremental, churn,
multitenant, ingest and failover workloads), the failover drill it runs
(``failover``) and the language-model serving driver (``serve``: prefill
and a KV-cache decode loop)."""
