"""Entry points of the port (``repro.launch``): the serving driver
(``serve_bridges``: batched, single, incremental, churn, multitenant,
ingest and failover workloads), the failover drill it runs
(``failover``), the language-model serving driver (``serve``: prefill and
a KV-cache decode loop), the training driver (``train``), the meshes
(``mesh``), and the dry run (``dryrun``, over ``workloads`` and
``hlo_analysis``: every cell's per-rank cost, memory and collectives on
fake tensors over a fake world of 256 or 512 ranks)."""
