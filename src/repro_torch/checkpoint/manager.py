"""Fault-tolerant checkpointing (``repro.checkpoint.manager``).

Atomic step checkpoints: write to a temp dir, fsync, CRC every array, write
a manifest last, then atomically rename. A crash mid-write can never
corrupt the latest checkpoint; restore picks the newest manifest whose CRCs
verify. The on-disk format is the reference's byte for byte (``step-%010d``
directories, one ``.npy`` per leaf, ``manifest.json`` with each leaf's
file, CRC32, dtype and shape), so a checkpoint written by either package
restores in the other.

Leaves are saved as host numpy arrays (a tensor on the card is copied to
the host first). numpy has no bfloat16: a ``torch.bfloat16`` leaf is saved
through its int16 view, with ``bfloat16`` as the manifest's dtype, and a
leaf whose manifest says ``bfloat16`` (int16 from this package, two-byte
void records from the reference) comes back as a ``torch.bfloat16``
tensor. Every other leaf comes back as a numpy array.

Elastic restart: a checkpoint holds whole logical arrays, so
``reshard_checkpoint`` places a restored tree onto any ``DeviceMesh``.

Serving-side layers on the same atomic core: ``CheckpointPolicy`` gives
the engine an every-K-write-ops snapshot cadence for its live state, and
``MachineCheckpoints`` keys independent per-machine stores for the
distributed failover path.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.launch.mesh import spec_placements
from repro_torch.optim.tree import tree_map


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array to save and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _restored(arr: np.ndarray, dtype: str):
    """A loaded array in the manifest's logical dtype."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    want = np.dtype(dtype)
    return arr if arr.dtype == want else arr.view(want)


def _flatten(tree, prefix=""):
    """dict/list pytree -> {path: leaf} with stable, readable keys."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(skeleton, flat, prefix=""):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        seq = [
            _unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(skeleton)
        ]
        return type(skeleton)(seq) if isinstance(skeleton, tuple) else seq
    return flat[prefix[:-1]]


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, tree) -> Path:
        flat = _flatten(tree)
        tmp = self.dir / f".tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "arrays": {}}
        for name, leaf in flat.items():
            arr, dtype = _host_array(leaf)
            fname = name.replace("/", "__") + ".npy"
            path = tmp / fname
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            crc = zlib.crc32(path.read_bytes()) & 0xFFFFFFFF
            manifest["arrays"][name] = {
                "file": fname,
                "crc32": crc,
                "dtype": dtype,
                "shape": list(arr.shape),
            }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.dir / f"step-{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step-*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def _verify(self, path: Path) -> dict | None:
        mf = path / "manifest.json"
        if not mf.exists():
            return None
        manifest = json.loads(mf.read_text())
        for name, meta in manifest["arrays"].items():
            f = path / meta["file"]
            if not f.exists():
                return None
            if (zlib.crc32(f.read_bytes()) & 0xFFFFFFFF) != meta["crc32"]:
                return None
        return manifest

    def latest_step(self) -> int | None:
        for path in sorted(self.dir.glob("step-*"), reverse=True):
            if self._verify(path) is not None:
                return int(path.name.split("-")[1])
        return None

    def steps(self) -> list[int]:
        """Every verified checkpoint step, newest first. The failover path
        walks these: recovery wants the newest snapshot satisfying a
        caller-side predicate (coverage disjointness), not just the newest
        one (``core.merge.simulate_failover_host``)."""
        return [int(p.name.split("-")[1])
                for p in sorted(self.dir.glob("step-*"), reverse=True)
                if self._verify(p) is not None]

    def restore_flat(self, step: int | None = None):
        """Skeleton-free restore: (step, {path: array}) of the newest
        verified checkpoint, or (None, None). The paths are the manifest's
        ``/``-joined tree keys; callers that rebuild typed state from the
        paths themselves (``BridgeEngine.restore_live``) use this instead
        of ``restore`` because the saved tree's shape — e.g. WHICH
        certificates were materialized — is data, not a skeleton the caller
        could know up front."""
        candidates = sorted(self.dir.glob("step-*"), reverse=True)
        if step is not None:
            candidates = [self.dir / f"step-{step:010d}"]
        for path in candidates:
            manifest = self._verify(path)
            if manifest is None:
                continue  # torn checkpoint: fall back to the previous one
            flat = {}
            for name, meta in manifest["arrays"].items():
                flat[name] = _restored(np.load(path / meta["file"]),
                                       meta["dtype"])
            return manifest["step"], flat
        return None, None

    def restore(self, skeleton, step: int | None = None):
        """Restore into the structure of `skeleton` (shapes/dtypes preserved
        from disk). Returns (step, tree) or (None, None) if nothing valid."""
        found, flat = self.restore_flat(step)
        if found is None:
            return None, None
        return found, _unflatten_into(skeleton, flat)


class MachineCheckpoints:
    """Per-machine checkpoint stores for the serving fleet.

    One ``CheckpointManager`` per machine id under ``<dir>/machine-<i>``,
    so each machine snapshots on its own cadence and a torn write on one
    machine can never invalidate another's latest checkpoint. This is the
    disk-backed store behind the failover path
    (``core.merge.simulate_failover_host``,
    ``launch.failover.serve_failover``): per-machine certificate states go
    in as small ``{"src","dst","mask"}`` trees and come back flat,
    manifest+CRC verified.
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._managers: dict = {}

    def manager(self, machine) -> CheckpointManager:
        if machine not in self._managers:
            self._managers[machine] = CheckpointManager(
                self.dir / f"machine-{machine}", keep=self.keep)
        return self._managers[machine]

    def save(self, machine, step: int, tree) -> Path:
        return self.manager(machine).save(step, tree)

    def restore_latest(self, machine):
        """(step, flat tree) of the machine's newest verified checkpoint,
        or None if it never checkpointed (or every snapshot is torn)."""
        step, flat = self.manager(machine).restore_flat()
        if step is None:
            return None
        return step, flat

    def steps(self, machine) -> list[int]:
        """Verified snapshot steps for one machine, newest first (the
        failover recovery walk — same protocol as the in-memory store)."""
        return self.manager(machine).steps()

    def restore(self, machine, step: int):
        """Flat tree of one specific verified snapshot."""
        found, flat = self.manager(machine).restore_flat(step)
        if found is None:
            raise KeyError(f"machine {machine} has no valid step {step}")
        return flat


class CheckpointPolicy:
    """Every-K-write-ops checkpoint cadence for a live serving state.

    The engine calls ``on_write`` after each applied write op (insert /
    delete batch); every ``every``-th write snapshots the state tree —
    built lazily by ``tree_factory``, so non-checkpointing writes pay
    nothing — through the wrapped ``CheckpointManager`` (atomic manifest +
    CRC). The *checkpoint currency rule*: a checkpoint is usable for
    recovery iff every write since it landed can be replayed by the
    recovering party; under this policy the exposure window is at most
    ``every - 1`` write ops, and ``last_step`` tells the caller exactly how
    stale the newest snapshot is.
    """

    def __init__(self, manager: CheckpointManager, every: int = 8):
        if every < 1:
            raise ValueError(f"checkpoint cadence must be >= 1, got {every}")
        self.manager = manager
        self.every = int(every)
        self.saves = 0
        self.restores = 0
        self.last_step: int | None = None
        self._since = 0

    def on_write(self, step: int, tree_factory) -> Path | None:
        """Count one write op; checkpoint when the cadence comes due."""
        self._since += 1
        if self._since < self.every:
            return None
        return self.checkpoint(step, tree_factory())

    def checkpoint(self, step: int, tree) -> Path:
        """Snapshot now, regardless of cadence (engine ``checkpoint_now``)."""
        path = self.manager.save(step, tree)
        self.saves += 1
        self.last_step = step
        self._since = 0
        return path

    def snapshot(self) -> dict:
        """Counter rollup merged into ``BridgeEngine.snapshot()``."""
        return {"saves": self.saves, "restores": self.restores,
                "every": self.every, "last_step": self.last_step,
                "pending_writes": self._since}


def reshard_checkpoint(tree, mesh, specs):
    """Elastic restart: place a host-restored tree onto a (new) mesh. Each
    leaf becomes a ``DTensor`` on ``mesh`` laid out by its spec in
    ``specs`` (a tree of partition specs in the port's tuple form, see
    ``launch.mesh.spec_placements``). Every rank of the mesh calls it with
    the same tree."""
    def put(leaf, spec):
        return distribute_tensor(torch.as_tensor(leaf), mesh,
                                 spec_placements(mesh, spec))

    return tree_map(put, tree, specs)
