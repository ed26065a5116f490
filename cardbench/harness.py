"""The benchmark's harness: one run of one cell.

Everything a cell is made of is found by name, so that a later change adds
a configuration, a generator, a traffic mix, a client or a metric by
adding a file and an entry of ``BENCHMARK.json``, and edits nothing here:

* ``configs/<name>.json``: a configuration's sizes, source and guarantees;
* ``generators/<name>.py``: a ``make(config, g)`` that draws the graph a
  configuration names, on the device, from a seeded generator;
* ``traffic/<name>.json``: a traffic mix's parameters, naming its client;
* ``clients/<name>.py``: a ``Client`` that makes the cell's inputs from
  the seed, warms the program on them, sends request ``i`` and judges the
  answers against the plain reference (``reference/``);
* ``metrics/<name>.py``: a ``read(run)`` that gives the metric's number
  from a ``Run``, or None where it finds nothing to read.

A run makes the inputs, warms the program, then sends requests in a
closed loop with one client for ``--seconds`` while the card's own
activity is profiled (on a card, in every run: the card's time a request
is read from it; ``--trace 1`` also records the program's spans), reads
the peak of device memory, frees the program's state, judges the answers
and prints one JSON line. The numbers it compares are printed beside
their limits, last on standard error and under ``checks``, the result's
last key.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

from cardbench.parts import BENCH_DIR, find, load_json, load_module

ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its parts resolved."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(manifest: dict, workload: str, roots=(BENCH_DIR,)) -> Cell:
    """The cell ``workload`` of ``manifest``: its configuration and
    traffic files, and the metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has "
                       f"{sorted(cells)}")
    entry = cells[workload]
    config = load_json(find("configs", entry["config"], roots))
    traffic = load_json(find("traffic", entry["traffic"], roots))
    return Cell(
        name=workload, config=config, traffic=traffic,
        chips=int(entry["chips"]),
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)])


@dataclasses.dataclass
class Run:
    """What a metric reader reads. Times are host-clock seconds; ``spans``
    are the program's tracer spans over the window, only in a traced run;
    ``trace`` the card's profile over the window, in every run on a card
    (None on the CPU); ``launches`` are the program's kernel launches in
    the window; ``facts`` what the client knows of its inputs
    (``n_edges``; ``forest_edges``, the reference's)."""

    cell: Cell
    setup_s: float
    window_s: float
    latencies_s: list
    attempted: int
    failed: int
    peak_bytes: int | None
    launches: dict
    facts: dict
    spans: list = dataclasses.field(default_factory=list)
    trace: object = None


def read_metrics(run: Run, entries: list, roots=(BENCH_DIR,)) -> dict:
    """Each entry's number by its reader; a reader that finds nothing is
    left out."""
    out = {}
    for entry in entries:
        value = load_module(find("metrics", entry["name"], roots)).read(run)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def _launch_counts() -> dict:
    from repro_torch.kernels import launch_counts

    return launch_counts()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float | None = None,
             roots=(BENCH_DIR,), stamps=()) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's dict,
    with the numbers compared under ``checks``. ``stamps``: ``(phase,
    perf_counter at its end)`` of set-up before the call, printed with
    the rest of set-up's phases."""
    import torch

    import repro_torch  # noqa: F401  (the program, timed as its own phase)
    from cardbench import graphs

    started = time.perf_counter() if started is None else started
    on_card = torch.device(device).type == "cuda"
    stamps = list(stamps)
    client_mod = load_module(find("clients", cell.traffic["client"], roots))
    stamps.append(("program import", time.perf_counter()))
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        stamps.append(("CUDA context", time.perf_counter()))
    client = client_mod.Client(cell.config, cell.traffic,
                               graphs.generator(seed, device), device, seed,
                               roots)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stamps.append(("inputs", time.perf_counter()))
    client.warm()
    stamps.append(("warm-up", time.perf_counter()))

    tracer = profile = None
    if trace:
        from repro_torch.obs import disable_tracing, enable_tracing

        tracer = enable_tracing()
    if on_card:
        from cardbench.devtrace import DeviceTrace

        profile = DeviceTrace()
    launches0 = _launch_counts()
    latencies, answers, failed = [], [], 0
    window = profile.window() if profile else contextlib.nullcontext()
    with window:
        t0 = time.perf_counter()
        setup_s = t0 - started
        i = 0
        while True:
            call = client.request(i)
            a = time.perf_counter()
            try:
                answers.append(call())
            except Exception as exc:  # a request that fails is counted
                traceback.print_exc(file=sys.stderr)
                answers.append(exc)
                failed += 1
            b = time.perf_counter()
            latencies.append(b - a)
            i += 1
            if b - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a) in
        zip(stamps, [("start", started)] + stamps)), file=sys.stderr)
    launches = {k: v - launches0.get(k, 0)
                for k, v in _launch_counts().items()}
    spans = []
    if tracer is not None:
        spans = tracer.spans()
        disable_tracing()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else None
    closing = [time.perf_counter()]
    if profile is not None and trace:
        profile.summary(spans)
    elif profile is not None:
        profile.busy_s()
    closing.append(time.perf_counter())

    client.close()
    if on_card:
        torch.cuda.empty_cache()
    checks, facts = client.check(answers)
    closing.append(time.perf_counter())
    print(f"after the window: the profiler's stop "
          f"{profile.stop_s if profile else 0.0:.3f} s, its reduction "
          f"{closing[1] - closing[0]:.3f} s, the check "
          f"{closing[2] - closing[1]:.3f} s", file=sys.stderr)
    # a request that raised is never correct, whatever the client judged
    checks = {"failed_requests": {"value": failed, "limit": 0}, **checks}

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s,
              latencies_s=latencies, attempted=len(answers), failed=failed,
              peak_bytes=peak, launches=launches, facts=facts, spans=spans,
              trace=profile)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end,
                           roots)
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(answers) and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and profile is not None:
        summary = profile.summary(spans)
        print(f"traced: {len(answers)} requests in {window_s:.3f} s, "
              f"profiled window {summary['window_s']:.3f} s, "
              f"{summary['device_events']} device events", file=sys.stderr)
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in
                           summary["device_ops"][:10]],
            "idle_gaps": [[n[:200], s] for n, s in
                          summary["idle_gaps"][:10]]}
    result["checks"] = checks
    return result


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (by default, the
    modules this process holds), each name compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, started: float | None = None) -> int:
    """Run one cell on the card and print its result line; 2 without the
    cards the cell asks for, 3 if a forbidden module was loaded."""
    args = parse_args(argv)
    cell = resolve_cell(load_json(MANIFEST), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    stamps = [("torch import and CUDA check", time.perf_counter())]
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", started, stamps=stamps)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
