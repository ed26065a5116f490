#!/usr/bin/env python3
"""SASRec's train step on the card, taken apart.

    python3 tools/profile_sasrec_train.py

At full width (``configs/sasrec.py::CONFIG``, weights from ``init_sasrec``
with the card's generator seeded as ``chip_smoke.py`` seeds it, TF32 off):

1. ``gather`` — the table's rows gathered by indexing (``x[ids]``, the
   gather ``graph/datastructs.py::take_fill`` used before it went through
   ``F.embedding``) against ``F.embedding``, in turns in one process
   (indexing, embedding, embedding, indexing), each turn a cold step and
   three warm ones of ``make_recsys_steps(CONFIG)["train"]`` at
   train_batch's B = 65,536 x S = 50 from the same weights: seconds, loss,
   grad_norm, and per gather the device time of the table gradients'
   kernel in one more warm step under ``torch.profiler``.
2. ``kinks`` — one loss and gradient at the train check's B = 1,024, in
   float32 on the card and on the CPU and in float64 on the card (the
   attention's core and the loss's logits stay float32 there, as
   ``chunked_causal_attention`` and ``sasrec_train_loss`` compute): the
   gradient of the loss with respect to the rows the sequences look up,
   per user, against float64; and every ReLU pre-activation whose sign
   differs between the two float32 runs, by block and user.
3. ``check`` — the train check's three steps at B = 1,024 on the card and
   on the CPU: per leaf, the largest error over the leaf's largest
   magnitude and the elements beyond 1e-5 of it.

Prints one JSON line per part, then the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.tree import tree_leaves  # noqa: E402

CFG = smoke.SASREC
WARM = 3
#: the name of each gather's backward kernel in the profile
SCATTER_KERNELS = ("indexing_backward_kernel", "sum_and_scatter")


def indexing_take_fill(x, idx):
    """``take_fill`` with its rows gathered by indexing: the same rows,
    indexing's backward."""
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    inside = (wrapped >= 0) & (wrapped < n)
    rows = x[wrapped.clamp(0, n - 1)]
    shape = inside.shape + (1,) * (x.dim() - 1)
    return torch.where(inside.reshape(shape), rows, float("nan"))


def scatter_us(train, params, opt, batch) -> float:
    """Device microseconds of the table gradients' kernel in one step."""
    from torch.profiler import ProfilerActivity, profile

    smoke.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train(params, opt, batch)
        smoke.sync()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.name for k in SCATTER_KERNELS))


def part_gather(params) -> dict:
    train = smoke.make_recsys_steps(CFG)["train"]
    batches = smoke.recsys_batches(CFG.n_items, smoke.TRAIN_BATCH,
                                   CFG.seq_len, seed=smoke.SEED)
    batch = [batches(i) for i in range(1 + WARM)]
    gathers = {"indexing": indexing_take_fill, "embedding": rec.take_fill}
    turns = []
    try:
        for label in ("indexing", "embedding", "embedding", "indexing"):
            rec.take_fill = gathers[label]
            p, opt, secs = params, adamw_init(params), []
            for b in batch:
                p, opt, r = smoke.train_step_record(train, p, opt, b)
                secs.append(r["seconds"])
            turns.append({"gather": label, "cold_s": secs[0],
                          "warm_s": secs[1:],
                          "warm_median_s": statistics.median(secs[1:]),
                          "loss": r["loss"], "grad_norm": r["grad_norm"],
                          "peak_device_bytes": r["peak_device_bytes"]})
            if label not in {t["gather"] for t in turns[:-1]}:
                turns[-1]["scatter_us"] = scatter_us(train, p, opt, batch[1])
            del p, opt
            torch.cuda.empty_cache()
    finally:
        rec.take_fill = gathers["embedding"]
    return {"part": "gather", "B": smoke.TRAIN_BATCH, "S": CFG.seq_len,
            "turns": turns}


class Capture(TorchFunctionMode):
    """Keeps the rows of the first ``F.embedding`` call (the sequences'
    lookup; their gradient retained) and every ``torch.relu`` input."""

    def __init__(self):
        super().__init__()
        self.rows, self.pre = None, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.embedding and self.rows is None:
            out.retain_grad()
            self.rows = out
        elif func is torch.relu:
            self.pre.append(args[0].detach())
        return out


def loss_and_capture(params, batch, dtype):
    def leaf(v):
        return v.to(dtype).detach().requires_grad_(True)

    p = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    p["blocks"] = [{k: leaf(v) for k, v in blk.items()}
                   for blk in params["blocks"]]
    with Capture() as cap:
        loss = rec.sasrec_train_loss(p, batch, CFG)
    loss.backward()
    return loss.item(), cap.rows.grad.double().cpu(), [
        z.cpu() for z in cap.pre]


def part_kinks(params) -> dict:
    batch = smoke.recsys_batches(CFG.n_items, smoke.TRAIN_CHECK_BATCH,
                                 CFG.seq_len, seed=smoke.SEED)(0)
    runs = {"card": loss_and_capture(params, batch, torch.float32),
            "cpu": loss_and_capture(smoke.params_to(params, "cpu"), batch,
                                    torch.float32),
            "float64": loss_and_capture(params, batch, torch.float64)}
    ref = runs["float64"][1]
    scale = float(ref.abs().max())
    out = {"part": "kinks", "B": smoke.TRAIN_CHECK_BATCH,
           "loss": {k: v[0] for k, v in runs.items()},
           "row_grad_scale": scale, "users": {}}
    for side in ("card", "cpu"):
        err = (runs[side][1] - ref).abs().amax(dim=(1, 2))
        median = float(err.median())
        out["users"][side] = {
            "median_err": median,
            "beyond_100x_median": {int(u): float(err[u]) for u in
                                   (err > 100 * median).nonzero()[:, 0]}}
    flips = []
    for block, (zc, zh) in enumerate(zip(runs["card"][2], runs["cpu"][2])):
        where = ((zc > 0) != (zh > 0)).nonzero()
        for b, s, j in where.tolist():
            flips.append({"block": block, "user": b, "position": s,
                          "unit": j, "card": float(zc[b, s, j]),
                          "cpu": float(zh[b, s, j])})
    out["relu_sign_flips"] = flips
    return out


def part_check(params) -> dict:
    train = smoke.make_recsys_steps(CFG)["train"]
    batches = smoke.recsys_batches(CFG.n_items, smoke.TRAIN_CHECK_BATCH,
                                   CFG.seq_len, seed=smoke.SEED)
    card, cpu = params, smoke.params_to(params, "cpu")
    oc, oh = adamw_init(card), adamw_init(cpu)
    for i in range(smoke.TRAIN_CHECK_STEPS):
        card, oc, _ = train(card, oc, batches(i))
        cpu, oh, _ = train(cpu, oh, batches(i))
    names = ["blocks/%d/%s" % (i, k) for i in range(CFG.n_blocks)
             for k in sorted(params["blocks"][0])] + ["item_emb", "pos_emb"]
    leaves = {}
    for label, a, b in (("params", card, cpu),
                        ("master", oc["master"], oh["master"]),
                        ("m", oc["m"], oh["m"]), ("v", oc["v"], oh["v"])):
        for name, x, y in zip(names, tree_leaves(a), tree_leaves(b)):
            err = (x.cpu() - y).abs()
            scale = max(float(y.abs().max()), 1e-30)
            leaves[f"{label}/{name}"] = {
                "err_over_scale": float(err.max()) / scale,
                "beyond_1e-5": int((err > 1e-5 * scale).sum())}
    return {"part": "check", "B": smoke.TRAIN_CHECK_BATCH,
            "steps": smoke.TRAIN_CHECK_STEPS, "leaves": leaves}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sasrec_train: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = rec.init_sasrec(CFG, torch.Generator(device="cuda").manual_seed(
        smoke.SEED))
    for part in (part_gather, part_kinks, part_check):
        print(json.dumps(part(params)), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
