"""Models of the port. SASRec (``recsys``): serving, its training loss and
its multi-card branches; the decoder-only language models
(``transformer``): forward, prefill with the KV stacks, loss and the
decode step, dense or with the mixture-of-experts layer of ``moe``
(``MoEConfig``, ``moe_ffn_local``, ``make_moe_layer``); GPipe pipeline
parallelism over the decoder (``pipeline``); the graph networks
(``gnn``: GraphSAGE, PNA, EGNN, GatedGCN). Import the submodules
directly, as in the reference."""
