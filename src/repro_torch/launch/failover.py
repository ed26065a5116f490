"""Fault-tolerant distributed serving drill: survive machine loss
mid-serve (``repro.launch.failover``).

The drill runs an M-machine serving fleet in one process — per-machine
edge shards, per-machine sparse certificates on the card, a full merge
schedule every step — under write churn, then kills a machine mid-serve
and measures the recovery end to end:

* **Liveness** — every serving machine beats a ``runtime.watchdog.
  HeartbeatMonitor`` once per step (logical clock: ``now = step``). The
  ``FailureInjector`` kill makes the victim fall silent; it keeps serving
  degraded results (its shard's certificate is missing from the merge)
  until the monitor declares it dead — the detection window, reported as
  ``detection_steps`` and ``degraded_steps``.
* **Durability** — every ``ckpt_every`` steps each machine snapshots its
  OWN certificate through ``checkpoint.MachineCheckpoints`` (atomic
  manifest + CRC). The *checkpoint currency rule*: a snapshot recovers the
  dead machine's certificate iff no write landed on its shard after the
  snapshot (``ckpt_step >= last_write_step``) — otherwise the designated
  survivor re-certifies the dead shard from the durable edge partition.
* **Recovery** — the lowest-id survivor adopts the dead shard: restores or
  re-certifies its certificate (``recover/checkpoint_restore`` /
  ``recover/recertify`` spans), folds it into its own (``recover/fold``),
  replays the writes that queued while the victim was silently dead, and
  the fleet re-merges under the degraded plan —
  ``ceil(log2(survivors))`` phases. Each loss handled ticks the global
  ``failures/recovered`` counter.
* **Parity** — every step's merged certificate is checked against a host
  DFS over ALL live edges (including the dead shard's). Post-recovery
  steps must match exactly; only the detection window may serve degraded.

The per-step merge always starts from per-machine certificates, so every
union in it covers disjoint shard sets and the disjoint union lemma
applies directly.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np

import torch

from repro_torch.checkpoint import MachineCheckpoints
from repro_torch.core.bridges_host import bridges_dfs, bridges_from_edgelist
from repro_torch.core.certificate import (
    certificate_capacity,
    sparse_certificate,
)
from repro_torch.core.merge import empty_certificate, merge_phase_plan
from repro_torch.core.partition import partition_edges
from repro_torch.graph import generators as gen
from repro_torch.graph.datastructs import (
    INT,
    EdgeList,
    admission_capacity,
    concat_edges,
    resolve_device,
)
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.watchdog import HeartbeatMonitor

#: a machine is declared dead after missing this many logical-step beats
HEARTBEAT_TIMEOUT_STEPS = 1.5


class _Fleet:
    """Host-side serving fleet: per-machine shard arrays + certificates.

    Shards are plain numpy arrays (durable — the input partition survives
    any machine); certificates are ``EdgeList`` buffers on ``device``
    rebuilt only for machines whose shard changed since the last step (the
    dirty set), all at ONE fixed capacity bucket.
    """

    def __init__(self, shards, n_nodes: int, shard_cap: int, device):
        self.device = device
        self.n = n_nodes
        self.shard_cap = shard_cap
        self.cert_cap = certificate_capacity(n_nodes)
        self.shards = {i: (s.copy(), d.copy()) for i, (s, d) in
                       enumerate(shards)}
        self.certs: dict[int, EdgeList] = {}
        self.dirty = set(self.shards)
        self.last_write_step = {i: -1 for i in self.shards}

    def owner_of(self, es: int, ed: int, owners) -> int:
        """Deterministic write routing: hash the edge onto the owner ring."""
        return owners[(es + 31 * ed) % len(owners)]

    def apply_write(self, machine: int, ds, dd, step: int):
        s, d = self.shards[machine]
        self.shards[machine] = (np.concatenate([s, ds]),
                                np.concatenate([d, dd]))
        self.dirty.add(machine)
        self.last_write_step[machine] = step

    def certify(self, machine: int) -> EdgeList:
        tr = get_tracer()
        if machine in self.dirty:
            s, d = self.shards[machine]
            with tr.span("merge/certify", machine=machine) as sp:
                self.certs[machine] = sp.sync(sparse_certificate(
                    EdgeList.from_arrays(s, d, self.n,
                                         capacity=self.shard_cap,
                                         device=self.device),
                    capacity=self.cert_cap))
            self.dirty.discard(machine)
        return self.certs[machine]

    def all_edges(self, machines):
        ss = [self.shards[i][0] for i in machines]
        dd = [self.shards[i][1] for i in machines]
        return np.concatenate(ss), np.concatenate(dd)


def _merge_over(fleet: _Fleet, machines, schedule: str, grid):
    """One serving-step merge: per-machine certs through the phase plan of
    ``schedule`` renumbered onto ``machines``; returns the answering
    machine's certificate. Every union covers disjoint shards."""
    tr = get_tracer()
    machines = sorted(machines)
    states = {i: fleet.certify(i) for i in machines}
    sched, g = schedule, grid
    if schedule == "hierarchical" and (
            g is None or len(machines) != g[0] * g[1]):
        sched, g = "xor", None  # a loss breaks the rectangular grid
    plan = merge_phase_plan(sched, len(machines), grid=g)
    empty = empty_certificate(fleet.n, fleet.cert_cap, device=fleet.device)
    for q, pairs in enumerate(plan):
        recv = {machines[d]: states[machines[s]] for (s, d) in pairs}
        with tr.span(f"merge/level{q}", schedule=schedule,
                     machines=len(machines), receivers=len(recv)):
            states = {i: sparse_certificate(
                concat_edges(states[i], recv.get(i, empty)),
                capacity=fleet.cert_cap) for i in machines}
    return states[machines[0]], len(plan)


def serve_failover(args, *, device=None) -> dict:
    """The failover drill; returns the report dict.

    ``args`` is the namespace ``launch.serve_bridges.main`` builds from
    its command line (``--workload failover``), or any namespace with
    ``machines``, ``steps``, ``kill_machine``, ``kill_at_step``,
    ``ckpt_every``, ``ckpt_dir``, ``schedule``, ``n``, ``edges``,
    ``delta_edges`` and ``seed``. The fleet's certificates live on the
    card unless ``device`` names another."""
    dev = resolve_device(device)
    tr = get_tracer()
    metrics = get_metrics()
    m = args.machines
    steps = args.steps
    kill_at = args.kill_at_step if args.kill_machine is not None else None
    schedule = args.schedule
    grid = (2, m // 2) if schedule == "hierarchical" else None

    src, dst, _ = gen.planted_bridge_graph(args.n, args.edges, 3,
                                           seed=args.seed)
    ps, pd, pm = partition_edges(src, dst, args.n, m, seed=args.seed)
    shards = [(ps[i][pm[i]], pd[i][pm[i]]) for i in range(m)]
    shard_cap = admission_capacity(
        2 * max(len(s) for s, _ in shards)
        + (steps + 2) * args.delta_edges + 16)
    fleet = _Fleet(shards, args.n, shard_cap, dev)

    injector = FailureInjector(
        kill_schedule={args.kill_machine: kill_at}
        if kill_at is not None else None)
    monitor = HeartbeatMonitor(machines=range(m),
                               timeout=HEARTBEAT_TIMEOUT_STEPS)
    ckpt_every = args.ckpt_every
    store = None
    ckpt_dir = None
    if ckpt_every > 0:
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="failover-ckpt-")
        store = MachineCheckpoints(ckpt_dir)

    owners = list(range(m))        # shard owners still serving
    silent: set[int] = set()       # killed but not yet declared dead
    queued: list = []              # writes routed to a silent machine
    # counters are global and monotone; a process that runs several
    # drills needs this drill's deltas
    base = {name: metrics.counter(name).value
            for name in ("failures/injected", "failures/recovered",
                         "fleet/dead_machines")}
    # prime the monitor so a machine killed before its first beat is
    # still detectable (it registered, then fell silent)
    for i in owners:
        monitor.beat(i, now=-1.0)
    report: dict = {
        "machines": m, "steps": steps, "schedule": schedule,
        "kill": ({"machine": args.kill_machine, "at_step": kill_at}
                 if kill_at is not None else None),
        "ckpt_every": ckpt_every, "ckpt_dir": ckpt_dir,
        "degraded_steps": 0, "parity_failures_post_recovery": 0,
        "detection_steps": None, "recovery": None, "saves": 0,
    }

    def snapshot_certs(step):
        if store is None or step % ckpt_every:
            return
        for i in owners:
            if i in silent:
                continue  # a dead machine writes no snapshots
            c = fleet.certify(i)
            store.save(i, step, {"src": c.src, "dst": c.dst, "mask": c.mask,
                                 "coverage": np.asarray([i], np.int32)})
            report["saves"] += 1

    def recover(k: int, step: int):
        t0 = time.perf_counter()
        designated = min(i for i in owners if i != k and i not in silent)
        with tr.span("recover/machine", machine=k, step=step,
                     into=designated):
            rec, source, ck_step = None, "recertify", None
            if store is not None:
                for s in store.steps(k):
                    if s < fleet.last_write_step[k]:
                        break  # currency rule: stale — and older is staler
                    tree = store.restore(k, s)
                    with tr.span("recover/checkpoint_restore", machine=k,
                                 phase=s) as sp:
                        rec = sp.sync(EdgeList(
                            torch.as_tensor(tree["src"], dtype=INT,
                                            device=dev),
                            torch.as_tensor(tree["dst"], dtype=INT,
                                            device=dev),
                            torch.as_tensor(tree["mask"], dtype=torch.bool,
                                            device=dev), fleet.n))
                    source, ck_step = "checkpoint", s
                    break
            if rec is None:
                s, d = fleet.shards[k]
                with tr.span("recover/recertify", machine=k,
                             by=designated) as sp:
                    rec = sp.sync(sparse_certificate(
                        EdgeList.from_arrays(s, d, fleet.n,
                                             capacity=fleet.shard_cap,
                                             device=dev),
                        capacity=fleet.cert_cap))
            # the designated survivor adopts the dead shard: raw edges move
            # (the input partition is durable; only the machine is gone)
            # and the certificates FOLD — base cert ∪ recovered cert ∪
            # replayed writes in one bounded pass, O(certificate + replay),
            # never O(shard). Certify BEFORE adoption: folding after the
            # shard grew would cover the adopted edges twice, and
            # certificate union is multiset — a duplicated edge copy fakes
            # 2-edge-connectivity and erases a bridge.
            base_cert = fleet.certify(designated)
            parts = concat_edges(base_cert, rec)
            replayed = len(queued)
            if queued:
                qarr = np.asarray(queued, np.int32)
                parts = concat_edges(parts, EdgeList.from_arrays(
                    qarr[:, 0], qarr[:, 1], fleet.n, capacity=len(qarr),
                    device=dev))
            with tr.span("recover/fold", machine=k, into=designated,
                         replayed=replayed) as sp:
                fleet.certs[designated] = sp.sync(
                    sparse_certificate(parts, capacity=fleet.cert_cap))
            ks, kd = fleet.shards.pop(k)
            ds, dd = fleet.shards[designated]
            qs = qarr[:, 0] if queued else np.zeros(0, np.int32)
            qd = qarr[:, 1] if queued else np.zeros(0, np.int32)
            fleet.shards[designated] = (np.concatenate([ds, ks, qs]),
                                        np.concatenate([dd, kd, qd]))
            fleet.last_write_step[designated] = step
            fleet.dirty.discard(designated)  # the fold already covers it
            fleet.certs.pop(k, None)
            queued.clear()
        owners.remove(k)
        silent.discard(k)
        metrics.counter("failures/recovered").inc()
        latency = time.perf_counter() - t0
        report["detection_steps"] = step - kill_at
        report["recovery"] = {
            "machine": k, "into": designated, "source": source,
            "checkpoint_step": ck_step, "replayed_writes": replayed,
            "latency_s": latency, "at_step": step,
            "remerge_phases": len(merge_phase_plan(
                "xor" if schedule == "hierarchical" else schedule,
                len(owners) - len(silent))),
        }
        print(f"[failover] step {step}: machine {k} declared dead "
              f"(detected {report['detection_steps']} step(s) after kill) | "
              f"recovered via {source} into machine {designated} | "
              f"{replayed} queued write(s) replayed | "
              f"{latency * 1e3:.1f}ms", flush=True)

    parity_ok_steps = 0
    for step in range(steps):
        # 1. failure injection: the victim falls silent (no beat, no merge)
        for k in injector.killed_machines(step):
            silent.add(k)
            print(f"[failover] step {step}: machine {k} killed "
                  f"(silent; watchdog timeout "
                  f"{HEARTBEAT_TIMEOUT_STEPS} steps)", flush=True)
        # 2. heartbeats + death detection
        for i in owners:
            if i not in silent:
                monitor.beat(i, now=float(step))
        for k in monitor.newly_dead(now=float(step)):
            if k in owners:
                recover(k, step)
        # 3. write churn, routed by edge hash; writes owned by a silent
        #    machine queue until recovery reassigns the shard. Churn stays
        #    inside the first planted blob's node range so the planted
        #    bridges survive the whole drill — parity then compares a
        #    NON-trivial bridge set every step
        ds, dd = gen.random_graph(max(args.n // 4, 2), args.delta_edges,
                                  seed=args.seed + 1000 + step)
        by_owner: dict[int, list] = {}
        for es, ed in zip(ds.tolist(), dd.tolist()):
            o = fleet.owner_of(es, ed, owners)
            if o in silent:
                queued.append((es, ed))
            else:
                by_owner.setdefault(o, []).append((es, ed))
        for o, pairs in by_owner.items():
            arr = np.asarray(pairs, np.int32)
            fleet.apply_write(o, arr[:, 0], arr[:, 1], step)
        # 4. snapshot cadence (surviving machines only)
        snapshot_certs(step)
        # 5. serve: merge over machines that are actually participating
        serving = [i for i in owners if i not in silent]
        merged, phases = _merge_over(fleet, serving, schedule, grid)
        got = {tuple(sorted(p)) for p in bridges_from_edgelist(merged)}
        # 6. parity vs host recompute over ALL live edges (queued writes
        #    and silent machines' shards included — what the fleet OWES)
        all_s, all_d = fleet.all_edges(fleet.shards)
        if queued:
            qarr = np.asarray(queued, np.int32)
            all_s = np.concatenate([all_s, qarr[:, 0]])
            all_d = np.concatenate([all_d, qarr[:, 1]])
        want = {tuple(sorted(p)) for p in bridges_dfs(all_s, all_d, fleet.n)}
        if got == want:
            parity_ok_steps += 1
        elif silent:
            report["degraded_steps"] += 1
        else:
            report["parity_failures_post_recovery"] += 1

    report["parity_ok_steps"] = parity_ok_steps
    report["final_parity"] = got == want
    report["final_bridges"] = len(want)
    report["survivors"] = len(owners)
    report["merge_phases"] = phases
    report["counters"] = {
        name: metrics.counter(name).value - base[name]
        for name in ("failures/injected", "failures/recovered",
                     "fleet/dead_machines")}
    rec = report["recovery"]
    print(f"[failover] {steps} steps, {m} machines, schedule={schedule} | "
          f"final parity {'OK' if report['final_parity'] else 'FAIL'} "
          f"({report['final_bridges']} bridges, {report['survivors']} "
          f"survivors)", flush=True)
    if rec is not None:
        print(f"[failover] recovery: {rec['latency_s'] * 1e3:.1f}ms via "
              f"{rec['source']} | degraded {report['degraded_steps']} "
              f"step(s) | re-merge {rec['remerge_phases']} phase(s) | "
              f"{rec['replayed_writes']} replayed write(s)", flush=True)
    if kill_at is not None and report["recovery"] is None:
        raise AssertionError(
            "failover drill: the killed machine was never recovered "
            "(kill after the serve window? detection needs "
            f"~{HEARTBEAT_TIMEOUT_STEPS} steps of headroom)")
    if report["parity_failures_post_recovery"]:
        raise AssertionError(
            f"failover drill: {report['parity_failures_post_recovery']} "
            "non-degraded step(s) diverged from the host recompute")
    return report
