"""One-shot analyses that answer with one label per vertex: the
``oneshot`` client's requests (``repro_torch.analyze(src, dst, n,
kind=..., final=...)`` on host arrays of one of the traffic's
``variants`` relabelled copies, request ``i`` on copy ``i % variants``),
judged array for array (``np.array_equal``).

The plain reference (``reference/two_ecc.py``) runs once, on copy 0's
own arrays, and its labels are carried to each copy. A label is the
smallest id of its class in the copy's own ids, so the carry takes the
minimum of the copy's ids over each class (``carry_labels``); it does not
map the old label.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench.clients import oneshot
from cardbench.reference import two_ecc as reference


def carry_labels(labels: torch.Tensor, to_copy: torch.Tensor) -> np.ndarray:
    """Labels of a copy: vertex ``x`` of the labelled graph is
    ``to_copy[x]`` in the copy, and its class (all ``y`` with ``labels[y]
    == labels[x]``) is labelled with the least ``to_copy[y]``."""
    n = labels.numel()
    least = torch.full((n,), n, dtype=torch.int64, device=labels.device)
    least.scatter_reduce_(0, labels, to_copy, "amin")
    out = torch.empty_like(least)
    out[to_copy] = least[labels]
    return out.cpu().numpy()


class Client(oneshot.Client):
    def expected(self) -> list:
        """The reference's labels for each copy; the forest size."""
        if self.kind != "2ecc":
            raise ValueError(f"no reference for kind {self.kind!r}")
        got = reference.analyze(*self.arrays[0], self.n, self.device)
        self.facts["forest_edges"] = got["forest_edges"]
        labels = torch.as_tensor(got["labels"], device=self.device)
        perms = [torch.from_numpy(p).to(self.device) for p in self.perms]
        # vertex x of copy 0 is drawn vertex inv0[x], which is perm[inv0[x]]
        # in another copy
        inv0 = torch.argsort(perms[0])
        return [carry_labels(labels, perm[inv0]) for perm in perms]

    def check(self, answers: list):
        """``wrong_answers``: answers of the window that differ from the
        reference's labels or never came (limit 0)."""
        want = self.expected()
        wrong = sum(1 for i, got in enumerate(answers)
                    if not (isinstance(got, np.ndarray) and
                            np.array_equal(got, want[i % len(want)])))
        return {"wrong_answers": {"value": wrong, "limit": 0}}, self.facts
