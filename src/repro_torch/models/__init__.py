"""Models of the port. SASRec (``recsys``): serving, its training loss and
its multi-card branches; ``transformer`` holds only ``Parallelism`` so
far. The language models and graph networks wait for their slices."""
