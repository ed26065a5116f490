"""The ``bridges`` kind of the analysis registry
(``repro.connectivity.registry``): its result conversion. The device final
stage is ``connectivity.device.bridges``; the other kinds come with a later
slice."""
from __future__ import annotations


def _pair_set(out, n_nodes: int) -> set[tuple[int, int]]:
    s, d, m = (x.cpu().numpy() for x in out)
    s, d = s[m], d[m]
    return set((int(min(a, b)), int(max(a, b))) for a, b in zip(s, d))
