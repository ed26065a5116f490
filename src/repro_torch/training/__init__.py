"""Step builders of the port: SASRec's train step and serving steps."""
from repro_torch.training.steps import make_recsys_steps

__all__ = ["make_recsys_steps"]
