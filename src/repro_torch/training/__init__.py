"""Step builders of the port: SASRec's train step and serving steps, the
language model's train, prefill and decode steps, the graph networks'
train step."""
from repro_torch.training.steps import (
    make_gnn_train_step,
    make_lm_decode_step,
    make_lm_prefill_step,
    make_lm_train_step,
    make_recsys_steps,
)

__all__ = ["make_lm_train_step", "make_lm_prefill_step",
           "make_lm_decode_step", "make_recsys_steps", "make_gnn_train_step"]
