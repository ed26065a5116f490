"""Batched language-model serving driver (``repro.launch.serve``): prefill
and a decode loop with a KV cache, on the card unless the caller names
another device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
        --smoke --batch 4 --prompt-len 16 --gen 32

Random weights from a generator seeded with ``--seed``, prompts from one
seeded with ``--seed + 1`` (the same generator then draws the samples at
``--temperature > 0``); the two generators live on the run's device, so
the card and the CPU draw different weights for one seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.graph.datastructs import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import Parallelism
from repro_torch.training import make_lm_decode_step, make_lm_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits, temperature: float = 0.0,
                generator=None) -> torch.Tensor:
    """int32[B, 1]: the first maximal logit (``jnp.argmax``'s tie rule), or
    at ``temperature > 0`` a draw from ``softmax(logits / temperature)``."""
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)
    else:
        tok = logits.argmax(-1)[:, None]
    return tok.to(torch.int32)


def generate(cfg: tfm.LMConfig, params: dict, prompts, gen: int,
             temperature: float, generator) -> tuple:
    """Prefill ``prompts`` (int[B, P]) and decode ``gen`` tokens on the
    device of ``params``. Returns (the generated tokens, int32 numpy [B,
    gen]; ``{"prefill_s", "decode_s"}``, each timed to a synchronised end).
    The first token is the prefill's greedy one, the rest are greedy or,
    at ``temperature > 0``, drawn by ``generator`` (on the same device),
    as in the reference."""
    par = Parallelism.none()
    dev = params["embed"].device
    prompts = tfm.token_ids(prompts, dev)
    p = prompts.shape[1]
    prefill = make_lm_prefill_step(cfg, par, s_max=p + gen)
    decode = make_lm_decode_step(cfg, par)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = _next_token(logits)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, cache = decode(params, cache, tok, p + i + 1)
        tok = _next_token(logits, temperature, generator)
    tokens = torch.cat(out, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t0
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None, *, device=None):
    """The reference's flags and its two printed lines; returns the
    generated tokens (int32 numpy [B, gen]). Runs on ``device`` (the card
    unless named)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    spec = get(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    sampler = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=sampler, device=dev,
                            dtype=torch.int32)

    gen, secs = generate(cfg, params, prompts, args.gen, args.temperature,
                         sampler)
    t_prefill, t_decode = secs["prefill_s"], secs["decode_s"]
    print(f"prefill {args.batch}x{args.prompt_len} tok in "
          f"{t_prefill*1e3:.0f}ms; decode {args.gen} steps in "
          f"{t_decode*1e3:.0f}ms "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s)",
          flush=True)
    print("sample row 0:", gen[0][:16].tolist(), flush=True)
    return gen


if __name__ == "__main__":
    main()
