#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   — compile the CUDA kernels from ``src/repro_torch/csrc`` with
             nvcc for sm_90a; nvcc's time and ptxas's register/spill lines.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes, bit for bit (tolerance 0: integer
             outputs); kernel, plain and library times with CUDA events
             (warm-up, L2 flushed before every launch) beside the bound.
3. main    — ``repro_torch.find_bridges`` on the paper's Fig. 2 operating
             point (|V| = 100,000, |E| = 10,000,000, six planted bridges)
             with ``final="device"`` and ``final="host"``, each twice (cold,
             then warm), each run with the launch counts set to 0 just
             before it and read just after; then the same pipeline stage
             by stage for wall seconds per stage and Borůvka rounds per
             pass; then one warm device-final call under torch.profiler
             for the device's busy share and time by kernel.
4. check   — small worlds on the card against the host Tarjan and the
             planted truth; a mid-size pipeline on the card against the
             same pipeline on the CPU, buffer for buffer.

Then the card's name and power limit (nvidia-smi), the kernels line, and
last ``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero and prints no result. Without a card it exits 2.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import find_bridges
from repro_torch.connectivity.device import bridges
from repro_torch.connectivity.registry import _pair_set
from repro_torch.core.api import masked_arrays, pad_graph
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.core.certificate import (
    certificate_capacity,
    sparse_certificate_ex,
)
from repro_torch.core.forest import hook_round
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import INF32, INT
from repro_torch.kernels import (
    cuda_lib,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.boruvka_round import boruvka_round, boruvka_round_bytes
from repro_torch.kernels.boruvka_round.ref import boruvka_round_ref
from repro_torch.kernels.segment_min import kernel_path, segment_min
from repro_torch.kernels.segment_min.ref import segment_min_ref

#: the paper's Fig. 2 operating point (configs/bridges_dense.py::CONFIG)
N_NODES, N_EDGES, N_BRIDGES, SEED = 100_000, 10_000_000, 6, 0
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 256 << 20
SOURCE = "src/repro_torch/csrc/connectivity_rounds.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` launches, each
    after an L2 flush (a write of 256 MB, outside the timed interval)."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape}/{a.dtype} vs "
                             f"{b.shape}/{b.dtype}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def require_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version, max abs err {err}")
    return err


# ----------------------------------------------------------------- phases
def phase_build() -> dict:
    info = cuda_lib.build(force=True)
    cuda_lib.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    rec = {"phase": "build", "nvcc_s": info["seconds"],
           "flags": " ".join(cuda_lib.NVCC_FLAGS), "ptxas": ptxas}
    emit(rec)
    return rec


def phase_kernels(el, flush) -> dict:
    """Both kernels at the main path's shapes against their plain versions."""
    n = el.n_nodes
    e = el.capacity
    valid = el.mask & (el.src != el.dst)  # what the forest passes each round
    ident = torch.arange(n, dtype=INT, device=el.device)
    round2, _, _ = hook_round(el.src, el.dst, valid, ident, n)
    n_valid = int(valid.sum())
    b_bytes = boruvka_round_bytes(e, n, n_valid)
    b_rec = {"name": "boruvka_round", "route": "cuda",
             "path": kernel_path(el.device), "source": SOURCE,
             "replaces": "src/repro/kernels/boruvka_round/kernel.py:144",
             "shape": {"E": e, "n": n, "valid_slots": n_valid},
             "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "bound_bytes": b_bytes, "library_ms": None,
             "library_note": "no single PyTorch call computes this function"}
    errs = []
    for tag, labels in (("identity", ident), ("round2", round2)):
        args = (el.src, el.dst, valid, labels, n)
        errs.append(require_equal(f"boruvka_round[{tag}]",
                                  boruvka_round(*args),
                                  boruvka_round_ref(*args)))
        b_rec[f"ms_{tag}"] = time_ms(lambda: boruvka_round(*args), flush)
        b_rec[f"plain_ms_{tag}"] = time_ms(lambda: boruvka_round_ref(*args),
                                           flush)
    b_rec.update(max_abs_err=max(errs), ms=b_rec["ms_identity"],
                 plain_ms=b_rec["plain_ms_identity"],
                 components_round2=int(torch.unique(round2).numel()))

    # segment_min at the device final's shapes: one key per arc of the
    # certificate's Euler tour (2 * 2(n-1) arcs), one segment per vertex;
    # INF32 keys and out-of-range ids included
    a = 2 * certificate_capacity(n)
    gen_ = torch.Generator(device=el.device).manual_seed(SEED)
    keys = torch.randperm(a, generator=gen_, device=el.device).to(INT)
    keys[torch.rand(a, generator=gen_, device=el.device) < 0.1] = INF32
    ids = torch.randint(-1000, n + 1000, (a,), generator=gen_,
                        device=el.device, dtype=INT)
    ids[:4] = torch.tensor([-(2 ** 31), -1, n, INF32], dtype=INT)
    n_live = int((keys != INF32).sum())
    s_bytes = 4 * a + 4 * n_live + 4 * n
    err = require_equal("segment_min", segment_min(keys, ids, n),
                        segment_min_ref(keys, ids, n))
    idx64 = torch.where((ids >= 0) & (ids < n), ids, n).long()

    def library():
        out = torch.full((n + 1,), INF32, dtype=INT, device=el.device)
        return out.scatter_reduce_(0, idx64, keys, "amin", include_self=True)

    require_equal("segment_min[library]", segment_min(keys, ids, n),
                  library()[:n])
    s_rec = {"name": "segment_min", "route": "cuda",
             "path": kernel_path(el.device), "source": SOURCE,
             "replaces": "src/repro/kernels/segment_min/kernel.py:76",
             "shape": {"E": a, "n": n, "live_keys": n_live},
             "max_abs_err": err,
             "ms": time_ms(lambda: segment_min(keys, ids, n), flush),
             "plain_ms": time_ms(lambda: segment_min_ref(keys, ids, n), flush),
             "library_ms": time_ms(library, flush),
             "library_note": "Tensor.scatter_reduce_(amin) on ids already "
                             "mapped to a dump slot (that mapping untimed)",
             "bound_ms": s_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "bound_bytes": s_bytes}
    for rec in (b_rec, s_rec):
        emit({"phase": "kernel_check", **rec})
    return {"boruvka_round": b_rec, "segment_min": s_rec}


def run_main_path(src, dst, planted, final: str, run: str) -> dict:
    """One ``find_bridges`` call, launch counts zeroed just before it and
    read just after. ``run`` names it: the first call of a final pays the
    card's lazy loading of PyTorch's own kernels ("cold"), the second not
    ("warm")."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = find_bridges(src, dst, N_NODES, final=final)
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if got != planted:
        raise AssertionError(f"find_bridges(final={final!r}) returned "
                             f"{sorted(got)}, planted {sorted(planted)}")
    rec = {"phase": "main_path", "final": final, "run": run,
           "seconds": seconds, "bridges": len(got), "launches": launches,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    return rec


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(src, dst, planted) -> dict:
    """One warm ``find_bridges(final="device")`` under ``torch.profiler``:
    device busy time (union of kernel intervals) against the call's wall
    time, and device time by kernel. The profiler's own overhead inflates
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = find_bridges(src, dst, N_NODES, final="device")
        sync()
        wall = time.perf_counter() - t0
    if got != planted:
        raise AssertionError("profiled find_bridges lost the planted bridges")
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for name, a, b in spans:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += b - a
    busy_s = _busy_us([(a, b) for _, a, b in spans]) / 1e6 if spans else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    rec = {"phase": "profile", "final": "device", "wall_s": wall,
           "device_events": len(spans), "device_busy_s": busy_s,
           "idle_share": None if busy_s is None else 1 - busy_s / wall,
           "by_kernel": [{"name": n[:100], "count": c, "us": t}
                         for n, (c, t) in top]}
    emit(rec)
    return rec


def run_stages(src, dst, planted) -> dict:
    """The same pipeline stage by stage: wall seconds per stage (each ends
    in a synchronize), Borůvka rounds per forest pass, host syncs."""
    sync()
    t0 = time.perf_counter()
    el = pad_graph(src, dst, N_NODES)
    sync()
    t1 = time.perf_counter()
    cert, _, _, (r1, r2) = sparse_certificate_ex(
        el, capacity=certificate_capacity(el.n_nodes))
    sync()
    t2 = time.perf_counter()
    before = launch_counts()["boruvka_round"]
    out = bridges(cert, el.n_nodes - 1)
    got_device = _pair_set((out.src, out.dst, out.mask), N_NODES)
    t3 = time.perf_counter()
    r_tour = launch_counts()["boruvka_round"] - before
    got_host = bridges_dfs(*masked_arrays((cert.src, cert.dst, cert.mask)),
                           N_NODES)
    t4 = time.perf_counter()
    if got_device != planted or got_host != planted:
        raise AssertionError("stage-by-stage pipeline lost the planted bridges")
    rec = {"phase": "stages", "n_bucket": el.n_nodes, "capacity": el.capacity,
           "real_edges": len(src), "certificate_edges": int(cert.mask.sum()),
           "pad_s": t1 - t0, "certificate_s": t2 - t1,
           "final_device_s": t3 - t2, "final_host_s": t4 - t3,
           "rounds": {"F1": r1, "F2": r2, "tour_forest": r_tour},
           "host_syncs_in_round_loops": r1 + r2 + r_tour}
    emit(rec)
    return rec


def phase_check() -> None:
    """Small worlds on the card against the truth, and a mid-size pipeline
    on the card against the same pipeline on the CPU."""
    worlds = [(sc["src"], sc["dst"], sc["n"], sc["bridges"])
              for sc in gen.failure_scenarios()]
    s, d, b = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    worlds.append((s, d, 3000, b))
    for src, dst, n, truth in worlds:
        for final in ("device", "host"):
            got = find_bridges(src, dst, n, final=final)
            if got != truth or got != bridges_dfs(src, dst, n):
                raise AssertionError(f"small world n={n} final={final}")
    cpu_el = pad_graph(s, d, 3000, device="cpu")
    gpu_el = pad_graph(s, d, 3000)
    buffers = 0
    for final in ("host", "device"):
        fn = make_analysis_fn(cpu_el.n_nodes, final)
        for a, b in zip(fn(cpu_el.src, cpu_el.dst, cpu_el.mask),
                        fn(gpu_el.src, gpu_el.dst, gpu_el.mask)):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"card and CPU pipelines differ "
                                     f"(final={final})")
            buffers += 1
    emit({"phase": "check", "worlds": len(worlds), "finals": 2,
          "buffers_equal_to_cpu": buffers})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    build = phase_build()

    t0 = time.perf_counter()
    src, dst, planted = gen.planted_bridge_graph(N_NODES, N_EDGES, N_BRIDGES,
                                                 seed=SEED)
    emit({"phase": "graph", "n": N_NODES, "edges": len(src),
          "bridges": len(planted), "host_s": time.perf_counter() - t0})

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    checks = phase_kernels(pad_graph(src, dst, N_NODES), flush)
    del flush

    main_runs = {}
    for final in ("device", "host"):
        cold = run_main_path(src, dst, planted, final, "cold")
        main_runs[final] = run_main_path(src, dst, planted, final, "warm")
        if cold["launches"] != main_runs[final]["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"final={final!r}")
    run_stages(src, dst, planted)
    phase_profile(src, dst, planted)
    phase_check()

    kernels = []
    for name, rec in checks.items():
        launches = main_runs["device"]["launches"][name]
        if launches <= 0 or rec["path"] != "cuda":
            raise AssertionError(f"{name}: the main path did not launch it")
        kernels.append({
            "name": name, "route": rec["route"], "path": rec["path"],
            "source": rec["source"], "replaces": rec["replaces"],
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels, "build_s": build["nvcc_s"]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
