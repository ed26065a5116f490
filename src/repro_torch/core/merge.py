"""Distributed certificate merging (paper §III phases) over
``torch.distributed`` (``repro.core.merge``).

Three schedules, all running on fixed 2(n−1)-slot certificate buffers:

  * ``paper`` — tree reduction. Phase q: machine ``i`` with
    ``i % 2^{q+1} == 2^q`` sends its certificate to ``i − 2^q`` and goes
    idle. SPMD detail kept from the reference: an "idle" machine still
    re-certifies its own buffer against an all-masked one every phase, so
    every machine's state equals the collective program's.
  * ``xor`` — recursive doubling: phase q exchanges with partner
    ``i XOR 2^q`` and every machine merges every phase; afterwards every
    machine holds the global certificate.
  * ``hierarchical`` — ``xor`` per mesh axis, the last-listed (fastest)
    axis first.

Certificate union is associative and commutative over DISJOINT edge
multisets (cert(cert(A) ⊎ cert(B)) certifies A ⊎ B), so every schedule
computes a certificate of the whole graph; every phase of every schedule
merges states covering disjoint shard subsets.

Two forms of the same schedules:

* the host simulator (``simulate_merge_host``, ``simulate_churn_host``):
  one process drives every machine's certificate in turn, on whatever
  device the certificates live on (the card, or the CPU in the tests);
* the failover drill (``simulate_failover_host``): the host simulator
  with a ``FailureInjector`` killing machines at phase boundaries, the
  lost certificate recovered from a snapshot or re-certified, and the
  survivors' coverage-disjoint states re-merged under the degraded plan
  (``degraded_phase_plan``);
* the process-group program (``build_distributed_analysis_fn``): every
  rank of a ``DeviceMesh`` runs it on its own shard, and the phases
  exchange certificates with ``dist.batch_isend_irecv``. The mesh's
  ``mesh_dim_names`` stand for the JAX mesh's axis names; machines are
  numbered row-major over ``machine_axes`` in the order listed, as
  ``lax.ppermute`` and ``P(axes, None)`` number them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
import torch.distributed as dist

from repro_torch.core.certificate import certificate_capacity, sparse_certificate
from repro_torch.core.certs import get_certificate
from repro_torch.graph.datastructs import (
    INT,
    ChunkedEdgeStream,
    EdgeList,
    compact_edges,
    concat_edges,
    resolve_device,
    tombstone_mask,
)
from repro_torch.obs import get_metrics, get_tracer

SCHEDULES = ("paper", "xor", "hierarchical")


def _phase_perm(schedule: str, m: int, q: int):
    stride = 1 << q
    if schedule == "paper":
        return [
            (i, i - stride)
            for i in range(m)
            if i % (2 * stride) == stride
        ]
    # xor recursive doubling
    return [(i, i ^ stride) for i in range(m) if (i ^ stride) < m]


def _phases(m: int) -> int:
    return max(int(math.ceil(math.log2(m))), 0)


def merge_phase_plan(schedule: str, m: int, grid=None):
    """The whole schedule as explicit phases: ``plan[q]`` is the list of
    ``(src, dst)`` machine-index pairs exchanged in phase ``q``.

    For ``paper``/``xor`` this is ``_phase_perm`` per phase; for
    ``hierarchical`` the per-row xor phases come first (every row exchanges
    at once, so each row's phase-q perms share one plan entry), then the
    per-column phases — the order ``simulate_merge_host`` runs them in.
    """
    if m <= 1:
        return []
    if schedule in ("paper", "xor"):
        return [_phase_perm(schedule, m, q) for q in range(_phases(m))]
    if schedule != "hierarchical":
        raise ValueError(f"unknown schedule {schedule!r}")
    rows, cols = grid if grid is not None else (2, m // 2)
    if rows * cols != m:
        raise ValueError(f"grid {rows}x{cols} != {m} machines")
    plan = []
    for q in range(int(math.ceil(math.log2(max(cols, 1))))):
        perm = _phase_perm("xor", cols, q)
        plan.append([(r * cols + s, r * cols + d)
                     for r in range(rows) for (s, d) in perm])
    for q in range(int(math.ceil(math.log2(max(rows, 1))))):
        perm = _phase_perm("xor", rows, q)
        plan.append([(s * cols + c, d * cols + c)
                     for c in range(cols) for (s, d) in perm])
    return plan


def degraded_phase_perm(schedule: str, alive, q: int):
    """Phase-``q`` permutation of the DEGRADED schedule: ``_phase_perm``
    recomputed over the surviving machine set, mapped back to the global
    machine ids through the rank-ordered survivor list. Survivors renumber
    densely, run the same recursive structure at size ``len(alive)``, and
    keep their ids."""
    alive = sorted(alive)
    return [(alive[s], alive[d])
            for (s, d) in _phase_perm(schedule, len(alive), q)]


def degraded_phase_plan(schedule: str, alive):
    """Re-merge plan after machine loss: ``(plan, degraded_schedule)``.

    The same schedule recomputed over the survivor set via
    ``degraded_phase_perm``; ``hierarchical`` falls back to flat ``xor``
    because a loss breaks the rectangular grid. Phase count is
    ceil(log2(survivors)) wherever in the old plan the loss happened:
    partial merge progress is never thrown away, the survivors'
    coverage-disjoint REPRESENTATIVE states re-merge (sound by the
    disjoint union lemma, see ``simulate_failover_host``)."""
    sched = "xor" if schedule == "hierarchical" else schedule
    alive = sorted(alive)
    plan = merge_phase_plan(sched, len(alive))
    return ([[(alive[s], alive[d]) for (s, d) in entry] for entry in plan],
            sched)


# ------------------------------------------------------------ host simulator
def empty_certificate(n_nodes: int, capacity: int | None = None,
                      device=None) -> EdgeList:
    """All-masked-off buffer: what a machine that receives nothing folds
    (a union no-op). On the card unless ``device`` names another."""
    cap = certificate_capacity(n_nodes) if capacity is None else capacity
    dev = resolve_device(device)
    return EdgeList(torch.zeros(cap, dtype=INT, device=dev),
                    torch.zeros(cap, dtype=INT, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev), n_nodes)


def certify_shards(psrc, pdst, pmask, n_nodes: int, certify=None) -> list:
    """Every machine's local certificate, machine by machine, from the
    stacked ``[M, cap]`` shard tensors (each row a machine's shard, on the
    tensors' device): the input of ``simulate_merge_host``. One
    ``merge/certify`` span per machine."""
    certify = sparse_certificate if certify is None else certify
    cap = certificate_capacity(n_nodes)
    tr = get_tracer()
    certs = []
    for i in range(psrc.shape[0]):
        with tr.span("merge/certify", machine=i) as sp:
            certs.append(sp.sync(certify(
                EdgeList(psrc[i], pdst[i], pmask[i], n_nodes),
                capacity=cap)))
    return certs


def simulate_merge_host(certs, schedule: str, certify=None, grid=None):
    """One merge schedule driven machine by machine in one process: no
    collectives, the real ``_phase_perm`` on a list of per-machine
    certificates, including the SPMD detail that a machine receiving
    nothing re-certifies against an empty buffer. Runs on the device the
    certificates live on.

    ``certify`` is the per-phase certificate builder (default: the 2-edge
    ``sparse_certificate``). ``grid=(rows, cols)`` lays the machines out
    for ``hierarchical`` (cols = fastest axis, merged first). Returns the
    per-machine certificates after all phases; under ``paper`` machine 0
    answers, under ``xor``/``hierarchical`` every machine holds the global
    certificate.
    """
    certify = sparse_certificate if certify is None else certify
    n = certs[0].n_nodes
    cap = certs[0].capacity
    empty = empty_certificate(n, cap, device=certs[0].device)

    def step(a, b):
        return certify(concat_edges(a, b),
                       capacity=certificate_capacity(n))

    def run_phases(cs, sched):
        m = len(cs)
        tr = get_tracer()
        for q in range(_phases(m)):
            perm = _phase_perm(sched, m, q)
            recv = {d: cs[s] for (s, d) in perm}
            # per-level span with per-machine children: the host-side view
            # of the paper's merge-phase cost term
            with tr.span(f"merge/level{q}", schedule=sched, machines=m,
                         receivers=len(perm)):
                out = []
                for i in range(m):
                    with tr.span("merge/machine", machine=i, level=q,
                                 receiving=i in recv) as sp:
                        out.append(sp.sync(step(cs[i], recv.get(i, empty))))
                cs = out
        return cs

    if schedule in ("paper", "xor"):
        return run_phases(list(certs), schedule)
    if schedule != "hierarchical":
        raise ValueError(f"unknown schedule {schedule!r}")
    m = len(certs)
    rows, cols = grid if grid is not None else (2, m // 2)
    if rows * cols != m:
        raise ValueError(f"grid {rows}x{cols} != {m} machines")
    g = [list(certs[r * cols:(r + 1) * cols]) for r in range(rows)]
    g = [run_phases(row, "xor") for row in g]
    for c in range(cols):
        col = run_phases([g[r][c] for r in range(rows)], "xor")
        for r in range(rows):
            g[r][c] = col[r]
    return [cert for row in g for cert in row]


def simulate_churn_host(shards, ksrc, kdst, schedule: str = "paper",
                        certify=None, grid=None):
    """The distributed deletion rule in one process: tombstone each
    machine's live edge shard with the (global, replicated) deletion keys,
    re-certify per machine, then re-run the merge phases — what
    ``build_distributed_analysis_fn(with_deletions=True)`` does, minus the
    collectives.

    ``shards``: per-machine ``EdgeList`` edge shards (not certificates).
    Returns the per-machine merged certificates, answering machine as in
    ``simulate_merge_host``.
    """
    certify = sparse_certificate if certify is None else certify
    tr = get_tracer()
    dev = shards[0].device
    ks = torch.as_tensor(ksrc, dtype=INT, device=dev)
    kd = torch.as_tensor(kdst, dtype=INT, device=dev)
    km = torch.ones(ks.shape, dtype=torch.bool, device=dev)
    certs = []
    for i, sh in enumerate(shards):
        with tr.span("merge/recertify", machine=i) as sp:
            m2, _ = tombstone_mask(sh.src, sh.dst, sh.mask, ks, kd, km)
            certs.append(sp.sync(
                certify(EdgeList(sh.src, sh.dst, m2, sh.n_nodes),
                        capacity=certificate_capacity(sh.n_nodes))))
    return simulate_merge_host(certs, schedule, certify=certify, grid=grid)


def stream_shard_states(shards, chunk_edges: int, certificate: str = "2ec"):
    """Per-shard STREAMED certificates: shard × chunk composition.

    Each machine's edge shard flows through its own ``ChunkedEdgeStream``
    and folds chunk by chunk through the registry's ``stream_load``: no
    machine holds its full shard buffer on the device. Sound by composing
    the two disjoint-union arguments: within a shard the chunks partition
    the shard's edges, so the streamed state certifies the shard; across
    shards the shards partition the graph, so the merge phases apply
    unchanged.

    Returns ``(certs, streams)``: the per-machine certificate pairs (ready
    for ``simulate_merge_host``) and the per-machine streams (spill rings
    and chunk/fold counters). The chunks live on the shards' device.
    """
    desc = get_certificate(certificate)
    certs, streams = [], []
    tr = get_tracer()
    for i, sh in enumerate(shards):
        stream = ChunkedEdgeStream(sh.n_nodes, chunk_edges, device=sh.device)
        s, d = sh.to_numpy()
        chunks = stream.admit(s, d)
        if not chunks:  # edgeless shard: one all-masked chunk fixes n_nodes
            chunks = [empty_certificate(sh.n_nodes, stream.chunk_bucket,
                                        device=sh.device)]
        cap = certificate_capacity(sh.n_nodes)
        with tr.span("stage/ingest", machine=i, chunks=len(chunks),
                     chunk_bucket=stream.chunk_bucket) as sp:
            state = sp.sync(desc.stream_load(chunks, cap))
        stream.folds += len(chunks)
        certs.append(EdgeList(state[0], state[1], state[2], sh.n_nodes))
        streams.append(stream)
    return certs, streams


def simulate_stream_merge_host(shards, chunk_edges: int,
                               schedule: str = "paper",
                               certificate: str = "2ec", grid=None):
    """Host-side sharded streaming drill: every machine streams its own
    chunk sequence (``stream_shard_states``), then the per-shard results
    compose through the real merge schedule (``simulate_merge_host``), the
    multi-machine variant of ``BridgeEngine.load_stream``. Returns
    ``(merged_certs, streams)``; answering machine as in
    ``simulate_merge_host``.
    """
    desc = get_certificate(certificate)
    certs, streams = stream_shard_states(shards, chunk_edges,
                                         certificate=certificate)
    merged = simulate_merge_host(certs, schedule, certify=desc.build,
                                 grid=grid)
    return merged, streams


class _MemoryCertStore:
    """In-process per-machine snapshot store: the simulator default when
    ``checkpoint_every`` is set without a disk store. Same protocol as
    ``checkpoint.MachineCheckpoints`` (``save``/``steps``/``restore``),
    which the serving path substitutes for real atomic+CRC snapshots.
    Keeps the full history: recovery walks snapshots newest-first and must
    be able to fall back when the newest one's coverage overlaps the
    survivors' (see ``simulate_failover_host``)."""

    def __init__(self):
        self._snaps: dict[int, dict[int, dict]] = {}

    def save(self, machine: int, step: int, tree: dict):
        self._snaps.setdefault(machine, {})[step] = dict(tree)

    def steps(self, machine: int) -> list[int]:
        """Snapshot steps for one machine, newest first."""
        return sorted(self._snaps.get(machine, {}), reverse=True)

    def restore(self, machine: int, step: int) -> dict:
        return self._snaps[machine][step]


def simulate_failover_host(shards, schedule: str, injector, *, certify=None,
                           grid=None, checkpoint_every=None, checkpoints=None):
    """Killed-machine merge drill: the host-side failover path, end to end.

    Runs the REAL phase plan (``merge_phase_plan``) machine-by-machine like
    ``simulate_merge_host``, but at every phase *boundary* asks the
    ``FailureInjector`` (``runtime.failures``) which machines die. A kill at
    boundary ``p`` means the machine completed phases ``0..p-1`` and its
    in-memory state is gone before phase ``p``.

    **Why re-merge needs care.** Every machine's state is a certificate of
    the union of some subset of the original per-machine certificates — its
    *coverage*. The schedules only ever union states with DISJOINT coverage,
    and that is load-bearing: certificates are fixed-capacity edge lists
    with multiset semantics, so unioning two states that both carry the same
    original copy of an edge duplicates it, the duplicate pair looks
    2-edge-connected, and a true bridge silently disappears. Union is NOT
    idempotent here. A naive "fold everything the survivors have back
    together" re-merge is therefore unsound; restarting from scratch throws
    away all O(E/M) certify work. The middle road:

    1. **Pick representatives.** Coverage sets form a laminar family (every
       union ever performed was disjoint), so the distinct maximal coverage
       sets among survivors are pairwise disjoint. One survivor per maximal
       set becomes a re-merge participant; survivors with nested/duplicate
       coverage sit out.
    2. **Recover only what is lost.** If some representative's coverage
       already contains the dead machine ``k`` (a survivor absorbed
       ``cert_k`` in an earlier phase), nothing is recovered — source
       ``"absorbed"``. Otherwise ``cert_k`` comes from ``k``'s NEWEST
       snapshot whose recorded coverage is disjoint from the
       representatives' (``recover/checkpoint_restore`` span) — a snapshot
       is a coverage-labelled certificate, so the disjointness check is
       exact — or, with no usable snapshot, the designated survivor
       (lowest-id representative) re-certifies ``shards[k]``
       (``recover/recertify`` span). The recovered certificate folds into
       the designated survivor (``recover/fold``), whose coverage grows
       accordingly — still disjoint from every other representative's.
    3. **Re-merge the representatives** under the degraded plan
       (``degraded_phase_plan``): ceil(log2(representatives)) phases. Every
       union in the re-merge is again disjoint, so the disjoint union lemma
       (cert(cert(A) ⊎ cert(B)) certifies A ⊎ B) applies verbatim — the
       exact soundness argument of the clean schedules. After the plan, the
       answering representative's certificate is fanned out to every
       survivor (one broadcast), restoring xor-style full redundancy.

    The phases rerun; the certificates do not — no per-shard certify work
    already done is repeated (the only new certify is the dead shard's, and
    only when no survivor or snapshot covers it).

    ``shards``: per-machine ``EdgeList`` EDGE shards (certificates are
    built here, like ``simulate_churn_host``). ``checkpoint_every=K``
    snapshots every live machine's coverage-labelled state at every K-th
    phase boundary into ``checkpoints`` (default: an in-memory store; pass
    ``checkpoint.MachineCheckpoints`` for the real atomic+CRC path).
    Boundary-``p`` kills are processed BEFORE the boundary-``p`` snapshot —
    a snapshot is only durable if its machine survives the boundary — so a
    kill at boundary 0 never finds a checkpoint. Each machine loss handled
    ticks the global ``failures/recovered`` counter.

    Returns ``(survivors, certs, info)``: the surviving machine ids, their
    final certificates (identical across survivors after a recovery
    fan-out; under a clean ``paper`` run machine 0 answers), and an info
    dict — ``clean_phases`` (boundaries survived before the first kill),
    ``remerge_phases``, ``killed``, ``recoveries`` (per-machine source:
    absorbed/checkpoint/recertify, + checkpoint phase), ``restarts``,
    ``answering``.
    """
    certify = sparse_certificate if certify is None else certify
    tr = get_tracer()
    n = shards[0].n_nodes
    cap = certificate_capacity(n)
    m = len(shards)
    dev = shards[0].device
    empty = empty_certificate(n, cap, device=dev)

    states: dict[int, EdgeList] = {}
    for i, sh in enumerate(shards):
        with tr.span("merge/certify", machine=i) as sp:
            states[i] = sp.sync(certify(sh, capacity=cap))
    cover: dict[int, frozenset] = {i: frozenset((i,)) for i in states}

    store = checkpoints
    if checkpoint_every and store is None:
        store = _MemoryCertStore()
    alive = sorted(states)
    participants = list(alive)
    info = {"schedule": schedule, "machines": m, "killed": [],
            "recoveries": [], "clean_phases": None, "remerge_phases": 0,
            "restarts": 0, "answering": 0}
    recovered_counter = get_metrics().counter("failures/recovered")

    def snapshot(tick):
        if not checkpoint_every or tick % checkpoint_every:
            return
        for i in alive:
            c = states[i]
            store.save(i, tick, {
                "src": c.src, "dst": c.dst, "mask": c.mask,
                "coverage": np.asarray(sorted(cover[i]), np.int32)})

    def pick_representatives():
        # Laminar family ⇒ distinct maximal coverage sets are pairwise
        # disjoint; largest-first greedy (ties to the lowest id) keeps
        # exactly one survivor per maximal set.
        reps, taken = [], set()
        for i in sorted(alive, key=lambda j: (-len(cover[j]), j)):
            if cover[i] & taken:
                continue
            reps.append(i)
            taken |= cover[i]
        return sorted(reps), taken

    def recover(k, tick, reps, taken):
        designated = min(reps)
        if k in taken:
            # some representative already absorbed cert_k in an earlier
            # phase — recovering a second copy would double-count it
            info["recoveries"].append({"machine": k, "source": "absorbed",
                                       "checkpoint_phase": None,
                                       "into": None})
            recovered_counter.inc()
            return taken
        with tr.span("recover/machine", machine=k, boundary=tick,
                     into=designated):
            rec, rec_cov, source, ck_phase = None, None, "recertify", None
            if store is not None:
                for step in store.steps(k):
                    tree = store.restore(k, step)
                    cov = frozenset(int(x) for x in tree["coverage"])
                    if cov & taken:
                        continue  # overlaps a representative: unusable
                    with tr.span("recover/checkpoint_restore", machine=k,
                                 phase=step) as sp:
                        rec = sp.sync(EdgeList(
                            torch.as_tensor(tree["src"], dtype=INT,
                                            device=dev),
                            torch.as_tensor(tree["dst"], dtype=INT,
                                            device=dev),
                            torch.as_tensor(tree["mask"], dtype=torch.bool,
                                            device=dev), n))
                    rec_cov, source, ck_phase = cov, "checkpoint", step
                    break
            if rec is None:
                with tr.span("recover/recertify", machine=k,
                             by=designated) as sp:
                    rec = sp.sync(certify(shards[k], capacity=cap))
                rec_cov = frozenset((k,))
            with tr.span("recover/fold", machine=k, into=designated) as sp:
                states[designated] = sp.sync(
                    certify(concat_edges(states[designated], rec),
                            capacity=cap))
            cover[designated] = cover[designated] | rec_cov
        recovered_counter.inc()
        info["recoveries"].append({"machine": k, "source": source,
                                   "checkpoint_phase": ck_phase,
                                   "into": designated})
        return taken | rec_cov

    sched = schedule
    plan = merge_phase_plan(schedule, m, grid=grid)
    q = 0       # position in the current plan
    tick = 0    # phase boundaries survived since merge start (never resets)
    while True:
        killed = [k for k in injector.killed_machines(tick) if k in alive]
        if killed:
            if info["clean_phases"] is None:
                info["clean_phases"] = tick
            for k in killed:
                alive.remove(k)
                states.pop(k)
                cover.pop(k)
                info["killed"].append(k)
            if not alive:
                raise RuntimeError("failover: every machine was killed")
            participants, taken = pick_representatives()
            for k in killed:
                taken = recover(k, tick, participants, taken)
            plan, sched = degraded_phase_plan(schedule, participants)
            info["restarts"] += 1
            info["remerge_phases"] = len(plan)
            q = 0
        snapshot(tick)
        if q >= len(plan):
            break
        pairs = plan[q]
        recv = {d: (states[s], cover[s]) for (s, d) in pairs}
        with tr.span(f"merge/level{q}", schedule=sched,
                     machines=len(participants), receivers=len(recv)):
            for i in participants:
                got = recv.get(i)
                with tr.span("merge/machine", machine=i, level=q,
                             receiving=got is not None) as sp:
                    other, other_cov = got if got else (empty, frozenset())
                    states[i] = sp.sync(
                        certify(concat_edges(states[i], other),
                                capacity=cap))
                    cover[i] = cover[i] | other_cov
        q += 1
        tick += 1
    if info["clean_phases"] is None:
        info["clean_phases"] = tick
    # the machine with full coverage answers; after a recovery the result
    # fans out to every survivor so the fleet returns to full redundancy
    answering = min((i for i in alive if len(cover[i]) == m),
                    default=min(alive))
    info["answering"] = answering
    if info["restarts"]:
        for i in alive:
            states[i] = states[answering]
            cover[i] = cover[answering]
    return alive, [states[i] for i in alive], info


# ------------------------------------------------------ process-group program
class MachineGroup:
    """The process group of one rank's machines: ``group``, the global rank
    of each machine index (``ranks``), this rank's machine index
    (``index``) and the machine count (``size``)."""

    def __init__(self, group, ranks: list[int]):
        self.group = group
        self.ranks = ranks
        self.index = ranks.index(dist.get_rank())
        self.size = len(ranks)


def machine_axes_of(mesh, machine_axes=None) -> tuple:
    """``machine_axes`` as a tuple of mesh dim names (default: all of
    them, in the mesh's order); unknown names raise."""
    names = tuple(mesh.mesh_dim_names or ())
    if machine_axes is None:
        axes = names
    elif isinstance(machine_axes, str):
        axes = (machine_axes,)
    else:
        axes = tuple(machine_axes)
    if not axes or any(a not in names for a in axes):
        raise ValueError(f"machine axes {axes} must name dims of the mesh "
                         f"{names}")
    return axes


def mesh_device(mesh, device=None) -> torch.device:
    """The device a mesh's buffers live on: ``device`` if given, which must
    be of the mesh's device type (ValueError otherwise), else the mesh's
    type (the current card for a ``cuda`` mesh)."""
    kind = mesh.device_type
    if device is None:
        if kind == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(kind)
    dev = torch.device(device)
    if dev.type != kind:
        raise ValueError(f"device {dev} is not of the mesh's device type "
                         f"{kind!r}")
    return dev


def flattened_ranks(mesh, machine_axes) -> list[list[int]]:
    """Every machine group's global ranks, one list per coordinate of the
    mesh's other dims: ranks row-major over ``machine_axes`` in the order
    listed (list position = machine index)."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in machine_axes]
    others = [d for d in range(len(names)) if d not in dims]
    m = math.prod(mesh.mesh.shape[d] for d in dims)
    # the rank grid's values, also under a dry run's fake mode
    with unset_fake_temporarily():
        return mesh.mesh.permute(*others, *dims).reshape(-1, m).tolist()


_GROUPS: dict[tuple, MachineGroup] = {}


def _first_collective(group, device_type: str) -> None:
    """One all-reduce over every rank of ``group``: NCCL lets a batched
    point-to-point call involve a subset of a group's ranks only after a
    collective over all of them."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    dist.all_reduce(torch.zeros(1, device=dev), group=group)


def machine_group(mesh, machine_axes) -> MachineGroup:
    """The group of this rank's machines over ``machine_axes``, flattened
    row-major in the order listed. One axis is the mesh's own group of that
    dim; several are a group made with ``dist.new_group``, which every rank
    calls for every group in the same order (a collective the first time
    for each ``(mesh, axes)``; cached after)."""
    axes = machine_axes_of(mesh, machine_axes)
    key = (id(mesh), axes)
    mg = _GROUPS.get(key)
    if mg is not None:
        return mg
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        mg = MachineGroup(group, dist.get_process_group_ranks(group))
    else:
        me = dist.get_rank()
        for ranks in flattened_ranks(mesh, axes):
            group = dist.new_group(ranks=ranks)
            if me in ranks:
                mg = MachineGroup(group, ranks)
    _first_collective(mg.group, mesh.device_type)
    _GROUPS[key] = mg
    return mg


def _exchange(state: tuple, mg: MachineGroup, perm) -> tuple:
    """One phase's ``ppermute`` of the pair ``state[:3]``: this machine
    sends to its partner and receives from its partner, in one
    ``batch_isend_irecv`` (a machine with nothing to do posts nothing). A
    machine that receives nothing gets zeros, an all-masked buffer, as
    ``ppermute``'s non-receivers do."""
    i = mg.index
    recv = tuple(torch.zeros_like(t) for t in state[:3])
    ops = []
    for s, d in perm:
        if s == i:
            ops += [dist.P2POp(dist.isend, t.contiguous(), mg.ranks[d],
                               group=mg.group) for t in state[:3]]
        if d == i:
            ops += [dist.P2POp(dist.irecv, t, mg.ranks[s], group=mg.group)
                    for t in recv]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv


def _merge_phases_one_axis(state: tuple, fold, n_nodes: int,
                           mg: MachineGroup, schedule: str) -> tuple:
    """log2(m) merge phases over one (possibly flattened) group of m
    machines. ``state`` is a certificate-registry state tuple (pair buffers
    first, aux arrays after — core.certs). Only the pair is exchanged; aux
    state (warm-start labels) stays machine-local, carried across phases
    by ``fold``. Non-receivers fold an all-masked buffer: a union no-op."""
    for q in range(_phases(mg.size)):
        perm = _phase_perm(schedule, mg.size, q)
        recv = _exchange(state, mg, perm)
        state = fold(state, EdgeList(*recv, n_nodes))
    return state


def merged_certificate(local: EdgeList, mesh, machine_axes,
                       schedule: str = "paper",
                       merge: str = "recertify",
                       certificate: str = "2ec") -> EdgeList:
    """This rank's local edge shard -> its certificate after every merge
    phase (under ``paper`` machine 0's is the global one; under
    ``xor``/``hierarchical`` every machine's is).

    ``machine_axes``: mesh dim names acting as "machines". For
    ``paper``/``xor`` they are flattened into one group; ``hierarchical``
    merges per axis, last-listed axis first (put the fastest axis last).

    ``merge``: ``recertify`` (re-certify the union each phase) or
    ``incremental`` (warm-start state carried across phases). Only
    certificates whose descriptor declares ``warm_merge`` warm-start; the
    rest re-certify the union each phase.

    ``certificate``: any name in the certificate registry (``core.certs``).
    """
    cert_desc = get_certificate(certificate)
    cap = certificate_capacity(local.n_nodes)
    if merge not in ("recertify", "incremental"):
        raise ValueError(f"unknown merge mode {merge!r}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    axes = machine_axes_of(mesh, machine_axes)
    if merge == "incremental" and cert_desc.warm_merge:
        state = cert_desc.load_state(local, cap)

        def fold(state, recv):
            return cert_desc.fold_state(state, recv, cap)
    else:
        c = cert_desc.build(local, capacity=cap)
        state = (c.src, c.dst, c.mask)

        def fold(state, recv):
            own = EdgeList(state[0], state[1], state[2], local.n_nodes)
            c2 = cert_desc.build(concat_edges(own, recv), capacity=cap)
            return c2.src, c2.dst, c2.mask

    if schedule == "hierarchical":
        for ax in reversed(axes):
            state = _merge_phases_one_axis(state, fold, local.n_nodes,
                                           machine_group(mesh, ax), "xor")
    else:
        state = _merge_phases_one_axis(state, fold, local.n_nodes,
                                       machine_group(mesh, axes), schedule)
    return EdgeList(state[0], state[1], state[2], local.n_nodes)


def build_distributed_analysis_fn(
    mesh,
    machine_axes,
    n_nodes: int,
    schedule: str = "paper",
    final: str = "device",
    merge: str = "recertify",
    kind: str = "bridges",
    with_deletions: bool = False,
    certificate: str | None = None,
):
    """Return the program every rank of ``mesh`` runs for ANY
    analysis-registry kind: ``(src, dst, mask[, ksrc, kdst, kmask]) ->``
    this rank's result buffers, its row of the reference's ``[M, ...]``
    output.

    ``src``, ``dst`` (int32) and ``mask`` (bool) are this rank's shard:
    row ``machine_group(mesh, machine_axes).index`` of the partition, on
    the mesh's device type (a mismatch raises; nothing is copied across
    devices). The program certifies the shard with the kind's certificate
    (or ``certificate``), runs the merge phases, then, with
    ``final='device'``, the kind's device final stage on the merged
    certificate; ``final='host'`` returns the merged certificate
    compacted into 2(n−1) slots, on which the caller runs the kind's host
    reference.

    ``with_deletions=True`` adds three replicated ``(ksrc, kdst, kmask)``
    deletion-key buffers: each machine tombstones its own shard before
    certifying, then the phases re-merge as usual (``simulate_churn_host``
    is the same rule in one process).
    """
    # Imported here: the registry builds on core's pipeline stages, so a
    # module-level import would be circular.
    from repro_torch.connectivity.common import tour_state
    from repro_torch.connectivity.registry import get_analysis

    analysis = get_analysis(kind)
    cert_name = certificate if certificate is not None else analysis.certificate
    axes = machine_axes_of(mesh, machine_axes)
    if final not in ("device", "host"):
        raise ValueError(f"unknown final stage {final!r}")
    cert_cap = certificate_capacity(n_nodes)
    out_cap = max(n_nodes - 1, 1)

    def body(src, dst, mask, *keys):
        if len(keys) != (3 if with_deletions else 0):
            raise TypeError(f"expected {3 if with_deletions else 0} key "
                            f"buffers, got {len(keys)}")
        for t in (src, dst, mask, *keys):
            if t.device.type != mesh.device_type:
                raise ValueError(
                    f"a buffer on {t.device} for a {mesh.device_type!r} "
                    f"mesh; move it to the mesh's device first")
        lmask = mask
        if with_deletions:
            lmask, _ = tombstone_mask(src, dst, lmask, *keys)
        local = EdgeList(src, dst, lmask, n_nodes)
        cert = merged_certificate(local, mesh, axes, schedule, merge,
                                  certificate=cert_name)
        if final == "device":
            st = tour_state(cert.src, cert.dst, cert.mask, n_nodes)
            return analysis.device_fn(cert.src, cert.dst, cert.mask,
                                      n_nodes, st, out_cap)
        o = compact_edges(cert, cert_cap)
        return o.src, o.dst, o.mask

    return body


def build_distributed_bridges_fn(
    mesh,
    machine_axes,
    n_nodes: int,
    schedule: str = "paper",
    final: str = "device",
    merge: str = "recertify",
):
    """Thin alias: the kind='bridges' distributed analysis."""
    return build_distributed_analysis_fn(
        mesh, machine_axes, n_nodes, schedule=schedule, final=final,
        merge=merge, kind="bridges")


def result_shard_zero(out, mesh, machine_axes):
    """Machine 0's result buffers on every rank of its machine group: a
    broadcast of each tensor of ``out`` (a tensor or a tuple of them) from
    machine 0 — the answer the reference's single controller reads from
    shard 0 of a ``[M, ...]`` result."""
    mg = machine_group(mesh, machine_axes)

    def from_zero(t):
        t = t.clone()
        dist.broadcast(t, src=mg.ranks[0], group=mg.group)
        return t

    if isinstance(out, torch.Tensor):
        return from_zero(out)
    return tuple(from_zero(t) for t in out)
