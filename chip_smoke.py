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
             before it and read just after; then one warm device-final
             call under torch.profiler for the device's busy share and
             time by kernel.
4. analyze — ``repro_torch.analyze`` at the same point for every kind with
             both finals, and ``cuts``/``bcc`` with ``final="host"`` under
             both vertex certificates (``sfs``, ``hybrid``): cold and warm
             walls, launches per kernel (counts set to 0 just before each
             run), host syncs in round loops, peak device memory, each
             answer held against the planted truth; then each of those
             pipelines stage by stage (wall seconds per stage, rounds per
             certificate pass) and ``cuts`` with either final under
             torch.profiler.
5. check   — small worlds on the card against the host oracles and the
             planted truth, every kind and final; the pipeline of every
             (kind, final, certificate) the registry allows on the card
             against the same pipeline on the CPU, buffer for buffer.

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

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import analyze, find_bridges
from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.registry import analysis_kinds, get_analysis
from repro_torch.core.api import masked_arrays, pad_graph, resolve_certificate
from repro_torch.core.bridges_host import bridges_dfs
from repro_torch.core.certificate import (
    certificate_capacity,
    hybrid_certificate_ex,
    sfs_certificate_ex,
    sparse_certificate_ex,
)
from repro_torch.core.certs import certificate_names
from repro_torch.core.forest import _sfs_impl, hook_round, spanning_forest_ex
from repro_torch.engine.batched import make_analysis_fn
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import INF32, INT
from repro_torch.kernels import (
    cuda_lib,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.boruvka_round import (
    boruvka_round,
    boruvka_round_bytes,
    frontier_round,
    frontier_round_bytes,
)
from repro_torch.kernels.boruvka_round.kernel import PACKED_INF
from repro_torch.kernels.boruvka_round.ref import (
    boruvka_round_ref,
    frontier_round_ref,
)
from repro_torch.kernels.segment_min import kernel_path, segment_min
from repro_torch.kernels.segment_min.ref import segment_min_ref

#: the paper's Fig. 2 operating point (configs/bridges_dense.py::CONFIG)
N_NODES, N_EDGES, N_BRIDGES, SEED = 100_000, 10_000_000, 6, 0
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 256 << 20
SOURCE = "src/repro_torch/csrc/connectivity_rounds.cu"
#: the (kind, final, certificate) runs of the analyze phase: every kind with
#: both finals under its declared certificate, and the vertex kinds' host
#: final under the other vertex certificate too (their device final runs
#: on the full buffer and builds no certificate)
ANALYZE_RUNS = [(kind, final, None)
                for kind in ("bridges", "cuts", "2ecc", "bridge_tree", "bcc")
                for final in ("device", "host")]
ANALYZE_RUNS += [("cuts", "host", "hybrid"), ("bcc", "host", "hybrid")]
#: the run whose launches the kernels line reports, per kernel
LAUNCHES_FROM = {"boruvka_round": "find_bridges(final='device')",
                 "segment_min": "find_bridges(final='device')",
                 "frontier_round": "analyze(kind='cuts', final='host')"}


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
    """Every kernel at the main path's shapes against its plain version."""
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
    f_rec = check_frontier_round(el, valid, n_valid, flush)
    for rec in (b_rec, s_rec, f_rec):
        emit({"phase": "kernel_check", **rec})
    return {"boruvka_round": b_rec, "segment_min": s_rec,
            "frontier_round": f_rec}


def sfs_rounds_plain(el) -> list:
    """``(frontier, visited)`` of every round of one scan-first-search pass
    (F1 of the ``sfs`` certificate) run with the plain round function, so
    that no frontier-round kernel made them."""
    rounds = []

    def recording_ref(src, dst, mask, frontier, visited, n):
        rounds.append((frontier.clone(), visited.clone()))
        return frontier_round_ref(src, dst, mask, frontier, visited, n)

    _, labels, _ = spanning_forest_ex(el)
    _sfs_impl(el.src, el.dst, el.mask, el.n_nodes, labels,
              round_fn=recording_ref)
    return rounds


def check_frontier_round(el, valid, n_valid: int, flush) -> dict:
    """``frontier_round`` at the main path's shapes on the frontier and
    visited sets of real BFS rounds, bit for bit against its plain version;
    kernel, plain and library times. The rounds: the first (its frontier
    is every root, the isolated padding vertices included), the widest
    frontier after it, and the round that reaches the most vertices (the
    most atomics). Also the kernel's mean time per launch over the pass."""
    n, e = el.n_nodes, el.capacity
    rounds = sfs_rounds_plain(el)
    sizes = [int(f.sum()) for f, _ in rounds]
    picks = {"first": 0,
             "widest": max(range(1, len(rounds)) or range(1),
                           key=sizes.__getitem__),
             "most_reached": max(range(len(rounds) - 1) or range(1),
                                 key=lambda i: sizes[i + 1])}
    f_bytes = frontier_round_bytes(e, n, n_valid)
    rec = {"name": "frontier_round", "route": "cuda",
           "path": kernel_path(el.device), "source": SOURCE,
           "replaces": "src/repro/kernels/boruvka_round/kernel.py:214",
           "shape": {"E": e, "n": n, "valid_slots": n_valid},
           "sfs_rounds": len(rounds), "frontier_sizes": sizes,
           "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bound_bytes": f_bytes,
           "library_note": "Tensor.scatter_reduce_(amin) over the int64 "
                           "keys parent * 2^32 + slot of the candidate arcs, "
                           "ids already mapped to a dump slot; the "
                           "candidate-mask pass that makes them is untimed"}
    errs = []
    arange = torch.arange(e, dtype=torch.int64, device=el.device)
    us = torch.cat([el.src, el.dst]).long()
    ws = torch.cat([el.dst, el.src])
    slots = torch.cat([arange, arange])
    v2 = torch.cat([valid, valid])
    for tag, i in picks.items():
        frontier, visited = rounds[i]
        args = (el.src, el.dst, valid, frontier, visited, n)
        got, want = frontier_round(*args), frontier_round_ref(*args)
        errs += [require_equal(f"frontier_round[{tag}].{part}", a, b)
                 for part, a, b in zip(("best_p", "best_e"), got, want)]
        cand = v2 & frontier[us] & ~visited[ws.long()]
        keys = us * (1 << 32) + slots
        idx = torch.where(cand, ws, n).long()

        def library():
            out = torch.full((n + 1,), PACKED_INF, dtype=torch.int64,
                             device=el.device)
            return out.scatter_reduce_(0, idx, keys, "amin",
                                       include_self=True)

        packed = library()[:n]
        require_equal(f"frontier_round[{tag}][library].best_p", got[0],
                      (packed >> 32).to(INT))
        require_equal(f"frontier_round[{tag}][library].best_e", got[1],
                      (packed & 0xFFFFFFFF).to(INT))
        rec[f"round_{tag}"] = i
        rec[f"reached_{tag}"] = int((got[0] < INF32).sum())
        rec[f"ms_{tag}"] = time_ms(lambda: frontier_round(*args), flush)
        rec[f"plain_ms_{tag}"] = time_ms(lambda: frontier_round_ref(*args),
                                         flush, iters=5)
        rec[f"library_ms_{tag}"] = time_ms(library, flush)
    pass_ms = [time_ms(lambda: frontier_round(el.src, el.dst, valid, f, v, n),
                       flush, iters=5, warmup=1) for f, v in rounds]
    rec.update(ms_pass_mean=statistics.fmean(pass_ms), ms_pass=pass_ms,
               max_abs_err=max(errs), ms=rec["ms_widest"],
               plain_ms=rec["plain_ms_widest"],
               library_ms=rec["library_ms_widest"])
    return rec


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


def phase_profile(label: str, call, check) -> dict:
    """One warm ``call()`` under ``torch.profiler``: device busy time
    (union of kernel intervals) against the call's wall time, and device
    time by kernel. The profiler's own overhead inflates the wall time.
    ``check(result)`` must hold."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = call()
        sync()
        wall = time.perf_counter() - t0
    if not check(got):
        raise AssertionError(f"profiled {label} gave a wrong answer")
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
    rec = {"phase": "profile", "run": label, "wall_s": wall,
           "device_events": len(spans), "device_busy_s": busy_s,
           "idle_share": None if busy_s is None else 1 - busy_s / wall,
           "by_kernel": [{"name": n[:100], "count": c, "us": t}
                         for n, (c, t) in top]}
    emit(rec)
    return rec


def planted_truth(n: int, n_bridges: int, planted: set) -> dict:
    """Every kind's answer on ``gen.planted_bridge_graph(n, m, n_bridges)``,
    from its layout: ``n_bridges + 1`` blobs of consecutive ids, each
    2-vertex-connected through its Hamiltonian cycle, joined in a chain by
    the planted bridges. The bridges' endpoints are the cut vertices, the
    blocks are the blobs and the bridge pairs, each blob's 2ECC label is
    its first vertex, and the bridge tree joins consecutive blobs."""
    k = n_bridges + 1
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    blobs = {frozenset(range(a, a + int(z))) for a, z in zip(starts, sizes)}
    return {"bridges": planted,
            "cuts": {v for pair in planted for v in pair},
            "bcc": blobs | {frozenset(pair) for pair in planted},
            "2ecc": np.repeat(starts, sizes),
            "bridge_tree": {(starts[b], starts[b + 1]) for b in range(k - 1)}}


def registry_combos() -> list:
    """Every (kind, certificate) pair the registries allow: the
    certificate preserves what the kind's declared one does."""
    combos = []
    for kind in analysis_kinds():
        for cert in certificate_names():
            try:
                resolve_certificate(kind, cert)
            except ValueError:
                continue
            combos.append((kind, cert))
    return combos


def same_answer(kind: str, got, want) -> bool:
    if kind == "2ecc":
        return bool(np.array_equal(got, want))
    return got == want


def run_label(kind: str, final: str, cert) -> str:
    extra = f", certificate={cert!r}" if cert else ""
    return f"analyze(kind={kind!r}, final={final!r}{extra})"


def run_analyze(src, dst, truth, kind: str, final: str, cert,
                run: str) -> dict:
    """One ``analyze`` call, launch counts zeroed just before it and read
    just after; its answer against the planted truth. Every round of a
    Borůvka or scan-first loop launches its kernel once and syncs the host
    once, so the round-loop syncs are those two launch counts."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = analyze(src, dst, N_NODES, kind=kind, final=final,
                  certificate=cert)
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if not same_answer(kind, got, truth[kind]):
        raise AssertionError(f"{run_label(kind, final, cert)} missed the "
                             f"planted truth")
    rec = {"phase": "analyze", "kind": kind, "final": final,
           "certificate": cert or get_analysis(kind).certificate,
           "run": run, "seconds": seconds, "launches": launches,
           "host_syncs_in_round_loops": (launches["boruvka_round"]
                                         + launches["frontier_round"]),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    return rec


def certificate_with_rounds(el, cert: str, cap: int):
    """The registry's certificate ``cert`` of ``el`` (built by its ``_ex``
    form) and the rounds of each of its passes."""
    if cert == "hybrid":
        buf, rounds = hybrid_certificate_ex(el, cap)
        return buf, dict(zip(("chain", "F1", "F2"), rounds))
    build_ex = {"2ec": sparse_certificate_ex, "sfs": sfs_certificate_ex}[cert]
    buf, _, _, rounds = build_ex(el, cap)
    return buf, dict(zip(("F1", "F2"), rounds))


def run_analysis_stages(src, dst, truth, kind: str, final: str,
                        cert) -> dict:
    """The pipeline of one analyze run stage by stage, as
    ``make_analysis_fn`` composes it: wall seconds per stage (each ends in
    a synchronize) and rounds per certificate pass."""
    analysis = get_analysis(kind)
    cert = cert or analysis.certificate
    sync()
    t0 = time.perf_counter()
    el = pad_graph(src, dst, N_NODES)
    sync()
    rec = {"phase": "analysis_stages", "kind": kind, "final": final,
           "certificate": cert, "pad_s": time.perf_counter() - t0}
    buf = el
    if final == "host" or analysis.device_input == "certificate":
        cap = certificate_capacity(el.n_nodes)
        t0 = time.perf_counter()
        buf, rec["rounds"] = certificate_with_rounds(el, cert, cap)
        sync()
        rec["certificate_s"] = time.perf_counter() - t0
    if final == "host":
        t0 = time.perf_counter()
        got = analysis.host_fn(*masked_arrays((buf.src, buf.dst, buf.mask)),
                               N_NODES)
        rec["final_host_s"] = time.perf_counter() - t0
    else:
        before = launch_counts()["boruvka_round"]
        t0 = time.perf_counter()
        st = tour_state(buf.src, buf.dst, buf.mask, el.n_nodes)
        sync()
        t1 = time.perf_counter()
        out = analysis.device_fn(buf.src, buf.dst, buf.mask, el.n_nodes, st,
                                 el.n_nodes - 1)
        sync()
        t2 = time.perf_counter()
        got = analysis.to_result(out, N_NODES)
        rec.update(tour_state_s=t1 - t0, final_device_s=t2 - t1,
                   to_result_s=time.perf_counter() - t2,
                   final_boruvka_rounds=(launch_counts()["boruvka_round"]
                                         - before))
    if not same_answer(kind, got, truth[kind]):
        raise AssertionError(f"stage-by-stage {kind}/{final}/{cert} missed "
                             f"the planted truth")
    emit(rec)
    return rec


def phase_analyze(src, dst, truth) -> dict:
    """Every analyze run of ``ANALYZE_RUNS`` cold then warm (launch counts
    equal across the two), then stage by stage."""
    runs = {}
    for kind, final, cert in ANALYZE_RUNS:
        cold = run_analyze(src, dst, truth, kind, final, cert, "cold")
        warm = run_analyze(src, dst, truth, kind, final, cert, "warm")
        if cold["launches"] != warm["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"{run_label(kind, final, cert)}")
        runs[run_label(kind, final, cert)] = warm
    for kind, final, cert in ANALYZE_RUNS:
        run_analysis_stages(src, dst, truth, kind, final, cert)
    for cert in ("sfs", "hybrid"):
        label = run_label("cuts", "host", None if cert == "sfs" else cert)
        if runs[label]["launches"]["frontier_round"] <= 0:
            raise AssertionError(f"{label} launched no frontier_round")
    return runs


def phase_check() -> None:
    """Small worlds on the card against the host oracles and the planted
    truth, every kind and final; the pipeline of every (kind, final,
    certificate) the registry allows on the card against the same pipeline
    on the CPU, buffer for buffer."""
    worlds = [(sc["src"], sc["dst"], sc["n"], sc["bridges"])
              for sc in gen.failure_scenarios()]
    s, d, b = gen.planted_bridge_graph(3000, 60_000, 5, seed=1)
    worlds.append((s, d, 3000, b))
    small_truth = planted_truth(3000, 5, b)
    combos = registry_combos()
    answers = 0
    for src, dst, n, truth in worlds:
        for final in ("device", "host"):
            got = find_bridges(src, dst, n, final=final)
            if got != truth or got != bridges_dfs(src, dst, n):
                raise AssertionError(f"small world n={n} final={final}")
            for kind, cert in combos:
                got = analyze(src, dst, n, kind=kind, final=final,
                              certificate=cert)
                oracle = get_analysis(kind).host_fn(src, dst, n)
                if not same_answer(kind, got, oracle) or (
                        n == 3000 and not same_answer(kind, got,
                                                      small_truth[kind])):
                    raise AssertionError(f"small world n={n} {kind}/{final}/"
                                         f"{cert}")
                answers += 1
    cpu_el = pad_graph(s, d, 3000, device="cpu")
    gpu_el = pad_graph(s, d, 3000)
    buffers = 0
    for kind, cert in combos:
        for final in ("host", "device"):
            fn = make_analysis_fn(cpu_el.n_nodes, kind, final,
                                  certificate=cert)
            want = fn(cpu_el.src, cpu_el.dst, cpu_el.mask)
            got = fn(gpu_el.src, gpu_el.dst, gpu_el.mask)
            if isinstance(want, torch.Tensor):
                want, got = (want,), (got,)
            for a, b in zip(want, got):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"card and CPU pipelines differ "
                                         f"({kind}/{final}/{cert})")
                buffers += 1
    emit({"phase": "check", "worlds": len(worlds), "finals": 2,
          "kind_certificate_pairs": combos,
          "answers_equal_to_oracles": answers,
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

    runs = {}
    for final in ("device", "host"):
        cold = run_main_path(src, dst, planted, final, "cold")
        runs[f"find_bridges(final={final!r})"] = warm = run_main_path(
            src, dst, planted, final, "warm")
        if cold["launches"] != warm["launches"]:
            raise AssertionError(f"launch counts differ between runs of "
                                 f"final={final!r}")
    phase_profile("find_bridges(final='device')",
                  lambda: find_bridges(src, dst, N_NODES, final="device"),
                  lambda got: got == planted)

    truth = planted_truth(N_NODES, N_BRIDGES, planted)
    runs.update(phase_analyze(src, dst, truth))
    for kind, final in (("cuts", "device"), ("cuts", "host")):
        phase_profile(run_label(kind, final, None),
                      lambda: analyze(src, dst, N_NODES, kind=kind,
                                      final=final),
                      lambda got: got == truth[kind])
    phase_check()

    kernels = []
    for name, rec in checks.items():
        launches = runs[LAUNCHES_FROM[name]]["launches"][name]
        if launches <= 0 or rec["path"] != "cuda":
            raise AssertionError(f"{name}: {LAUNCHES_FROM[name]} did not "
                                 f"launch it")
        kernels.append({
            "name": name, "route": rec["route"], "path": rec["path"],
            "source": rec["source"], "replaces": rec["replaces"],
            "launches": launches, "launches_from": LAUNCHES_FROM[name],
            "max_abs_err": rec["max_abs_err"],
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
