"""One-shot analyses: every request is the port's public entry
``repro_torch.analyze(src, dst, n, kind=..., final=...)`` on host arrays of
a whole graph, paying its host-to-card copy each time.

The traffic's ``variants`` relabelled copies of the configuration's graph
are made in set-up; request ``i`` analyses copy ``i % variants``. Every
answer of the window is judged: the plain reference runs once, on copy
0's own arrays, and its answer is carried to the other copies through
their permutations.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench import graphs
from cardbench.parts import BENCH_DIR
from cardbench.reference import connectivity as reference


class Client:
    def __init__(self, config: dict, traffic: dict, g: torch.Generator,
                 device: str, seed: int, roots=(BENCH_DIR,)):
        from repro_torch import analyze

        self._analyze = analyze
        self.kind = traffic["kind"]
        self.final = traffic["final"]
        self.device = device
        self.warm_calls = int(traffic["warm_calls"])
        graph = graphs.make(config, g, roots)
        self.n = graph.n_nodes
        perms = graphs.relabelings(self.n, int(traffic["variants"]), g)
        self.arrays = [(p[graph.src.long()].int().cpu().numpy(),
                        p[graph.dst.long()].int().cpu().numpy())
                       for p in perms]
        self.perms = [p.cpu().numpy() for p in perms]
        self.facts = {"n_edges": len(self.arrays[0][0])}
        del graph, perms

    def _call(self, variant: int):
        src, dst = self.arrays[variant]
        return lambda: self._analyze(src, dst, self.n, kind=self.kind,
                                     final=self.final, device=self.device)

    def warm(self) -> None:
        for _ in range(self.warm_calls):
            self._call(0)()

    def request(self, i: int):
        return self._call(i % len(self.arrays))

    def close(self) -> None:
        """The default engine behind ``analyze`` keeps only its programs:
        the edge buffers of a call are freed when it returns."""

    def expected(self) -> list:
        """The reference's answer for each copy, and the forest size."""
        got = reference.analyze(*self.arrays[0], self.n, self.device)
        self.facts["forest_edges"] = got["forest_edges"]
        # vertex x of copy 0 is drawn vertex inv0[x], which is perm[inv0[x]]
        # in another copy
        inv0 = np.argsort(self.perms[0])
        out = []
        for perm in self.perms:
            to_copy = perm[inv0]
            if self.kind == "bridges":
                out.append(graphs.relabel_pairs(got["bridges"], to_copy))
            elif self.kind == "cuts":
                out.append({int(to_copy[v]) for v in got["cuts"]})
            else:
                raise ValueError(f"no reference for kind {self.kind!r}")
        return out

    def check(self, answers: list):
        """``wrong_answers``: answers of the window that differ from the
        reference's or never came (limit 0)."""
        want = self.expected()
        wrong = sum(1 for i, got in enumerate(answers)
                    if got != want[i % len(want)])
        return {"wrong_answers": {"value": wrong, "limit": 0}}, self.facts
