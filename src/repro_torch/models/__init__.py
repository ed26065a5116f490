"""Models of the port. SASRec (``recsys``): serving, its training loss and
its multi-card branches; the dense decoder-only language models
(``transformer``): forward, prefill with the KV stacks, loss and the
decode step. The mixture-of-experts layers and the graph networks wait
for their slices."""
