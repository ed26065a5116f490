"""Step builders, ported from ``src/repro/training/steps.py``.

Only the recsys serving steps have come across. ``make_recsys_steps`` has
no ``train`` entry: SASRec training (its loss, AdamW and the cosine
schedule) waits for the training slice, the language-model and GNN steps
for theirs.
"""
from __future__ import annotations

from repro_torch.models import recsys as rec_mod


def make_recsys_steps(cfg: rec_mod.SASRecConfig) -> dict:
    """``serve(params, seq)`` -> [B, n_items] scores; ``bulk(params, seq)``
    -> top-100 (scores, ids) over 64 row chunks; ``retrieval(params,
    history, hist_mask, candidates)`` -> [B, C] scores. Each runs on the
    device of ``params`` (``init_sasrec`` and
    ``interop.sasrec_params_from_numpy`` put them on the card unless given
    ``device="cpu"``)."""

    def serve(params, seq):
        return rec_mod.serve_scores(params, seq, cfg)

    def bulk(params, seq):
        return rec_mod.serve_bulk_topk(params, seq, cfg)

    def retrieval(params, history, hist_mask, candidates):
        return rec_mod.retrieval_scores(params, history, hist_mask,
                                        candidates, cfg)

    return {"serve": serve, "bulk": bulk, "retrieval": retrieval}
