"""Models of the port. SASRec's serving path is here (``recsys``); the
language models and graph networks wait for their slices."""
