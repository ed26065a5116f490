"""End-to-end language-model training driver with fault tolerance
(``repro.launch.train``), on the card unless the caller names another
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --smoke --steps 200 --ckpt-dir /tmp/run1

  * auto-resume: the same command restarted continues from the newest
    intact checkpoint of ``--ckpt-dir`` (params and AdamW state), and the
    data resumes at the exact batch (``SyntheticTokens.batch_at(step)``);
  * a straggler watchdog (``StepWatchdog``, threshold 4) times every step,
    to the device's end of it;
  * ``--fail-at N`` simulates a host failure: the process exits with 17
    before step N, to drill the restart.

Random weights from a generator seeded with ``--seed`` on the run's
device, so the card and the CPU draw different weights for one seed;
``train`` takes given weights.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.graph.datastructs import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import Parallelism
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.tree import tree_map
from repro_torch.runtime import StepWatchdog
from repro_torch.training import make_lm_train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _onto(tree, like):
    """A restored tree (numpy arrays, bfloat16 leaves as tensors) as
    tensors of ``like``'s dtypes on its devices."""
    return tree_map(lambda new, old: torch.as_tensor(new).to(
        device=old.device, dtype=old.dtype), tree, like)


def train(cfg: tfm.LMConfig, params: dict, opt: dict, data, steps: int, *,
          lr: float = 1e-3, start: int = 0, mgr=None, ckpt_every: int = 20,
          fail_at: int | None = None, log_every: int = 10) -> tuple:
    """Steps ``start`` .. ``steps - 1`` of ``make_lm_train_step`` (AdamW at
    ``lr``, the cosine schedule over ``steps`` with a warmup of ``steps //
    20``, at least 1) on the device of ``params``, step ``i`` on
    ``data.batch_at(i)``. Prints the reference's lines: ``step`` every
    ``log_every`` steps and at the last, ``[failure]`` before exiting with
    17 at ``fail_at``, ``[watchdog]`` if a step straggled, ``final_loss``
    last. Saves ``{"params", "opt"}`` to ``mgr`` every ``ckpt_every`` steps
    and at the end. The steps are donated: ``params`` and ``opt`` are
    written in place, so the state is held once. Returns (params, opt, one
    record a step: ``step``, ``loss``, ``grad_norm``, ``lr``, ``seconds``
    to the device's end of the step)."""
    dev = params["embed"].device
    step_fn = make_lm_train_step(cfg, Parallelism.none(), AdamWConfig(lr=lr),
                                 total_steps=steps,
                                 warmup=max(steps // 20, 1), donate=True)
    wd = StepWatchdog(threshold=4.0)
    records = []
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            print(f"[failure] simulated host failure at step {step}",
                  flush=True)
            sys.exit(17)
        batch = data.batch_at(step)
        _sync(dev)
        wd.start()
        params, opt, metrics = step_fn(params, opt, batch)
        _sync(dev)
        dt = wd.stop(step)
        rec = {"step": step, "seconds": dt,
               **{k: metrics[k].item() for k in ("loss", "grad_norm", "lr")}}
        records.append(rec)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt})
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt})
    if wd.events:
        print(f"[watchdog] {len(wd.events)} straggler events", flush=True)
    print(f"final_loss {records[-1]['loss']:.4f}", flush=True)
    return params, opt, records


def main(argv=None, *, device=None):
    """The reference's flags and printed lines; returns the losses of the
    steps this run took. Runs on ``device`` (the card unless named)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a host failure at this step (exit 17)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    spec = get(args.arch)
    assert spec.family == "lm", "train.py drives LM archs"
    cfg = spec.smoke_config if args.smoke else spec.config
    dev = resolve_device(device)
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt = adamw_init(params)

    start, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            start, state = mgr.restore({"params": params, "opt": opt})
            params = _onto(state["params"], params)
            opt = _onto(state["opt"], opt)
            print(f"[resume] restored step {start}", flush=True)

    data = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed)
    _, _, records = train(cfg, params, opt, data, args.steps, lr=args.lr,
                          start=start, mgr=mgr, ckpt_every=args.ckpt_every,
                          fail_at=args.fail_at, log_every=args.log_every)
    return [r["loss"] for r in records]


if __name__ == "__main__":
    main()
