"""Multi-pod dry run, ported from ``src/repro/launch/dryrun.py``: trace
every (arch x shape x mesh) cell on the production meshes and record its
per-rank cost, memory and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b \\
        --shape train_4k --mesh single,multi

Writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
incrementally (resume: existing cells are skipped unless ``--force``),
with the reference's record keys, so that a roofline report can read both.

"Lowering" a cell here means: a fake world of 256 (``single``) or 512
(``multi``) ranks in this one process (the ``fake`` process-group
backend, rank 0), the production ``DeviceMesh`` over it, the workload's
fake arguments (``launch/workloads.py``) placed as ``DTensor``s by their
specs, and the step run once on rank 0 under ``implicit_replication()``
with ``_Recorder`` watching every op that reaches a local shard. Nothing
is allocated and nothing is sent. The record holds, per rank:

- ``flops``: the matmul-class flops ``torch.utils.flop_counter`` knows,
  counted on the local shards (what this rank computes);
- ``bytes accessed``: each op's local operands and results, once each,
  eager and without fusion (XLA counts after fusion);
- the collectives that ``DTensor`` inserts and that the islands issue
  (``launch/hlo_analysis.py``'s payload convention);
- ``memory``: the local shards of the arguments, the peak of live fake
  bytes beyond them, the local outputs. ``compile_s`` and
  ``generated_code_size_in_bytes`` have no counterpart (no compiler) and
  are recorded as ``None``.

The fake tensors live on ``cuda`` unless ``device="cpu"`` is given. The
fake world exists only inside ``run_cell``: it is created when no default
process group exists, and destroyed on the way out.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get
from repro_torch.launch.hlo_analysis import KINDS, collective_bytes, roofline_terms
from repro_torch.launch.mesh import make_production_mesh, spec_placements
from repro_torch.launch.workloads import build_workload, fake_mode
from repro_torch.optim.tree import tree_leaves

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: ops that move no data: views and bookkeeping
_FREE = {"aten.detach", "aten.alias", "aten.lift_fresh", "aten.empty",
         "aten.empty_strided", "aten._local_scalar_dense", "aten.set_",
         "aten.resize_"}
_METRICS = ("flops", "bytes accessed", "collective_bytes")


def _op_name(func) -> str:
    return func._schema.name.replace("::", ".")


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of
    them, nested)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _Recorder(TorchDispatchMode):
    """Records what one rank computes, moves and holds.

    An op on ``DTensor``s is counted once, on the ``DTensor``s: its flops
    are the global count (``flop_registry`` over the global shapes) over
    the product of the mesh sizes over which its output is ``Shard`` or
    ``Partial`` (a ``Replicate`` output is computed in full on every
    rank); its bytes are its arguments' and its outputs' local shards. The
    recorder re-enters itself around the op, so that the collectives
    ``DTensor`` runs on the local shards come back here (as in
    ``CommDebugMode``); the local ops inside it are not counted again
    (among them ``DTensor``'s own runs of the op on global fake shapes). An
    op on plain tensors outside a ``DTensor`` op (an island's body) is
    counted as it is. Live bytes are the local storages that ops created,
    each counted until it is freed (a weak reference's finalizer)."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = []
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._inside = 0  # depth of DTensor ops being run
        self._reentry = None
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.args_bytes = self.live

    def _track(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self._storages.pop(key, None)
        self.live -= n

    def _count(self, func, args, kwargs, out, flops: float) -> None:
        """Flops, bytes and live storages of one counted op."""
        self.flops += flops
        if not func.is_view and _op_name(func) not in _FREE:
            seen, total = set(), 0
            for x in (*args, *kwargs.values(), out):
                for t in (x if isinstance(x, (list, tuple)) else (x,)):
                    if isinstance(t, torch.Tensor) and id(t) not in seen:
                        seen.add(id(t))
                        total += _nbytes(t._local_tensor if isinstance(
                            t, DTensor) else t)
            self.bytes += total
        self._track_all(out)

    def _track_all(self, out) -> None:
        """Track the local storages of an op's outputs: a counted op's, a
        collective's, and those ``DTensor`` makes inside an op of its own
        (a gathered operand, a redistributed shard)."""
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self._track(t)

    def _from_tracked(self, xs) -> bool:
        """Whether a tensor in ``xs`` (nested lists and tuples) lies in a
        tracked storage: an op inside a ``DTensor`` op that works on a
        local shard, not one of the op's runs on fresh global-shape fake
        tensors that propagate its shapes."""
        for x in xs:
            if isinstance(x, (list, tuple)):
                if self._from_tracked(x):
                    return True
            elif (isinstance(x, torch.Tensor) and x.device.type != "meta"
                  and id(x.untyped_storage()) in self._storages):
                return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._reentry is func:  # our own re-dispatch: DTensor runs it
                self._reentry = None
                return NotImplemented
            self._reentry = func
            self._inside += 1
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._inside -= 1
                self._reentry = None
            packet = func._overloadpacket
            flops = 0
            if packet in flop_registry:
                first = out[0] if isinstance(out, (list, tuple)) else out
                flops = flop_registry[packet](*args, **kwargs, out_val=out)
                if isinstance(first, DTensor):
                    mesh = first.device_mesh
                    for i, p in enumerate(first.placements):
                        if p.is_shard() or p.is_partial():
                            flops /= mesh.size(i)
            self._count(func, args, kwargs, out, flops)
            return out
        name = _op_name(func)
        if name == "_c10d_functional.wait_tensor":
            return args[0]  # a fake wait would allocate a new tensor
        out = func(*args, **kwargs)
        if name in KINDS:
            self._collective(func, name, args, kwargs, out)
            self._track_all(out)
        elif not self._inside:
            packet = func._overloadpacket
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            self._count(func, args, kwargs, out, flops)
        elif self._from_tracked((*args, *kwargs.values())):
            self._track_all(out)  # DTensor's local work, not its shape runs
        return out

    def _collective(self, func, name, args, kwargs, out) -> None:
        operand = result = 0
        params = [a.name for a in func._schema.arguments]
        for pname, val in (*zip(params, args), *kwargs.items()):
            if pname.startswith("output"):
                result += _nbytes(val)
            else:
                operand += _nbytes(val)
        if KINDS[name] == "recv":
            operand, result = 0, operand
        elif not result:
            result = _nbytes(out[0] if isinstance(out, tuple) else out)
        self.coll.append((name, operand, result))


def _register_fake_backend() -> None:
    """Register the ``fake`` process-group backend. Torch keeps it in a
    private test module, ``torch.testing._internal.distributed.fake_pg``
    (tried with torch 2.11 and 2.13), which registers it on import; a torch
    without that module cannot run the dry run, and says so here."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as ex:
        raise RuntimeError(
            f"the dry run's fake world needs torch's 'fake' process-group "
            f"backend from torch.testing._internal.distributed.fake_pg "
            f"(tried with torch 2.11 and 2.13); torch {torch.__version__} "
            f"has no such module") from ex


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A default process group of ``n_ranks`` ranks in this one process
    (the ``fake`` backend: collectives send nothing), as rank 0; created
    only when none exists, and destroyed on the way out."""
    if dist.is_initialized():
        yield
        return
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place(args, specs, mesh):
    """The fake global ``args`` as ``DTensor``s on ``mesh``, placed by
    ``specs`` (the workload's ``in_shardings``: the same tree, a spec at
    each tensor), each local shard its own contiguous fake tensor."""
    if isinstance(args, dict):
        return {k: place(v, specs[k], mesh) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        out = [place(v, specs[i], mesh) for i, v in enumerate(args)]
        return tuple(out) if isinstance(args, tuple) else out
    pl = spec_placements(mesh, specs)
    d = distribute_tensor(args, mesh, pl, src_data_rank=None)
    local = d.to_local().contiguous().clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=d.shape, stride=d.stride())


def _local_bytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def trace_workload(wl: dict, mesh) -> tuple:
    """Run a workload's step once on this rank over ``mesh``: its fake
    arguments placed by its ``in_shardings``, under ``_Recorder``. Returns
    (metrics, memory record). The workload's arguments are consumed."""
    t0 = time.time()
    with fake_mode():
        args = place(wl.pop("args"), wl["in_shardings"], mesh)
        rec = _Recorder(args)
        with implicit_replication(), rec:
            out = wl["fn"](*args)
        t_lower = time.time() - t0
        coll = collective_bytes(rec.coll)
        mem = {
            "argument_size_in_bytes": rec.args_bytes,
            "output_size_in_bytes": _local_bytes(out),
            "temp_size_in_bytes": rec.peak - rec.args_bytes,
            "generated_code_size_in_bytes": None,
        }
    metrics = {
        "flops": float(rec.flops),
        "bytes accessed": float(rec.bytes),
        "collective_bytes": float(coll["total_bytes"]),
        "collectives": coll,
        "lower_s": round(t_lower, 2),
        "compile_s": None,
    }
    return metrics, mem


def _compile_workload(spec, shape_name, mesh, **build_kw):
    """Build and trace one workload variant; return (metrics, memory
    record)."""
    with fake_mode():
        wl = build_workload(spec, shape_name, mesh, **build_kw)
    return trace_workload(wl, mesh)


# The reference lowers L=2 and L=4 probes with every scan unrolled and
# extrapolates each metric linearly in L (M(L) = c + a*L, a = (M4-M2)/2),
# since XLA counts a loop body once. Eager tracing counts every layer, so
# here the probes only save time, and they are exact for identical
# layers: a language model's cell is traced at L=2 and L=4 only, and its
# memory record is extrapolated the same way (the arguments and the
# activations a remat step keeps grow by a layer's worth per layer).
_PROBE_L = (2, 4)
_MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
           "temp_size_in_bytes")


def probe_line(v2, v4, l_full: int) -> float:
    """A metric at ``l_full`` layers from its values at the probes' L = 2
    and L = 4, on the line through them."""
    a = (v4 - v2) / (_PROBE_L[1] - _PROBE_L[0])
    return v2 - _PROBE_L[0] * a + a * l_full


def _probe_extrapolate(spec, shape_name, mesh, l_full: int):
    """(the analysis entry, the memory record, the collectives, the
    seconds both probes took) of a language model's cell."""
    m2, mem2 = _compile_workload(spec, shape_name, mesh,
                                 n_layers=_PROBE_L[0], analysis=True)
    m4, mem4 = _compile_workload(spec, shape_name, mesh,
                                 n_layers=_PROBE_L[1], analysis=True)
    out = {k: probe_line(m2[k], m4[k], l_full) for k in _METRICS}
    out["method"] = f"probe-extrapolation L={_PROBE_L} -> {l_full}"
    out["probe_l2"] = {k: m2[k] for k in _METRICS}
    out["probe_l4"] = {k: m4[k] for k in _METRICS}
    mem = {k: int(round(probe_line(mem2[k], mem4[k], l_full)))
           for k in _MEMORY}
    mem["generated_code_size_in_bytes"] = None
    mem["method"] = out["method"]
    c2, c4 = m2["collectives"], m4["collectives"]
    coll = {part: {k: probe_line(c2[part][k], c4[part][k], l_full)
                   for k in c2[part]} for part in ("bytes", "counts")}
    coll["total_bytes"] = out["collective_bytes"]
    return out, mem, coll, m2["lower_s"] + m4["lower_s"]


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: Path,
             force: bool = False, *, device: str | None = None) -> dict:
    """Trace one cell and write its record; return it. ``device`` is the
    fake tensors' device type (``cuda`` unless given)."""
    device = device or "cuda"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch_id}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    spec = get(arch_id)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "status": "pending"}
    if shape_name in spec.skips:
        rec["status"] = "skipped"
        rec["reason"] = spec.skips[shape_name]
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type=device)
        n_chips = mesh.size()
        try:
            rec.update(_trace_cell(spec, shape_name, mesh))
            rec["n_chips"] = n_chips
            rec["roofline"] = roofline_terms(
                {"flops": rec["analysis"]["flops"],
                 "bytes accessed": rec["analysis"]["bytes accessed"]},
                {"total_bytes": rec["analysis"]["collective_bytes"]},
                n_chips)
            rec["status"] = "ok"
        except Exception as ex:
            rec["status"] = "error"
            rec["error"] = f"{type(ex).__name__}: {ex}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _trace_cell(spec, shape_name, mesh) -> dict:
    """The record's cost, memory, collective and analysis entries."""
    kind = spec.shapes[shape_name]["kind"]
    out = {"left_out": ["compile_s", "generated_code_size_in_bytes"]}
    if spec.family == "lm":
        ana, mem, coll, secs = _probe_extrapolate(spec, shape_name, mesh,
                                                  spec.config.n_layers)
        out.update(lower_s=round(secs, 2), compile_s=None,
                   cost_production={**{k: ana[k] for k in _METRICS},
                                    "method": "eager, no fusion; "
                                              + ana["method"]},
                   memory=mem, collectives=coll, analysis=ana)
        return out
    prod, mem = _compile_workload(spec, shape_name, mesh)
    out.update(lower_s=prod["lower_s"], compile_s=None,
               cost_production={**{k: prod[k] for k in _METRICS},
                                "method": "eager, no fusion"},
               memory=mem, collectives=prod["collectives"])
    ana = {k: prod[k] for k in _METRICS}
    if spec.family == "gnn" and spec.config.arch == "gatedgcn":
        ana["method"] = "full-unroll run (eager)"
    elif spec.family == "recsys" and kind == "bulk":
        ana["method"] = "full-unroll run (eager)"
    elif spec.family == "graph":
        # the round loops are data-dependent: each body ran once
        ana["method"] = "loop bodies once (see analytic model)"
    else:
        ana["method"] = "direct (no loops over layers in program)"
    out["analysis"] = ana
    return out


def main(argv=None, *, device: str | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--device", default=device,
                    help="the fake tensors' device type (default: cuda)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = args.mesh.split(",")
    n_ok = n_err = n_skip = 0
    for arch in archs:
        spec = get(arch)
        shapes = [args.shape] if args.shape else list(spec.shapes.keys())
        for shape in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind, out_dir,
                               force=args.force, device=args.device)
                dt = time.time() - t0
                status = rec["status"]
                n_ok += status == "ok"
                n_err += status == "error"
                n_skip += status == "skipped"
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']}"
                             f" tc={r['t_compute_s']:.2e}"
                             f" tm={r['t_memory_s']:.2e}"
                             f" tn={r['t_collective_s']:.2e}")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                print(f"[{status:>7}] {arch:>22} {shape:>14} {mesh_kind:>6}"
                      f" ({dt:5.1f}s){extra}", flush=True)
    print(f"done: {n_ok} ok / {n_skip} skipped / {n_err} errors", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
