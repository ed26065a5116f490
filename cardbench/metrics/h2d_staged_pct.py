"""Entry and pad: the share of the one-shot entry's copied bytes that went
through the card's pinned ring, 100 × Σ ``staged_bytes`` / Σ ``bytes`` over
the window's ``stage/pad/h2d`` spans; None where there is none (or where
the spans carry no ``staged_bytes``, as before the ring)."""


def read(run):
    spans = [s["attrs"] for s in run.spans if s["name"] == "stage/pad/h2d"]
    total = sum(a.get("bytes", 0) for a in spans)
    if not total or any("staged_bytes" not in a for a in spans):
        return None
    return 100.0 * sum(a["staged_bytes"] for a in spans) / total
