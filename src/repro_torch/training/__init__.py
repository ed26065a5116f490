"""Step builders of the port: SASRec's serving steps so far."""
