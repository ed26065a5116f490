"""The dry run's workloads (``launch/workloads.py``) against the JAX
package's, for all 84 (arch, shape, mesh) pairs.

Each side runs in a subprocess of its own, so that no test of this
worker sees a default process group or forced devices: the JAX package's
``build_workload`` on meshes of 512 forced host devices, the port's on
the production meshes over a fake world of 256 or 512 ranks (the dry
run's own ``fake_world``), with fake tensors on the CPU. For every pair
both sides give the same skip reason, or the same arguments: each leaf's
global shape and dtype, its sanitized partition spec, in one leaf order,
and the same ``donate_argnums``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

_JAX_PROGRAM = """
import json, sys
from repro.launch import dryrun  # forces 512 host devices first
import jax
from repro.configs import ARCH_IDS, get
from repro.launch.mesh import make_production_mesh
from repro.launch.workloads import build_workload

meshes = {"single": make_production_mesh(), "multi": make_production_mesh(
    multi_pod=True)}
out = {}
for arch in ARCH_IDS:
    spec = get(arch)
    for shape in spec.shapes:
        for kind, mesh in meshes.items():
            key = f"{arch}/{shape}/{kind}"
            try:
                wl = build_workload(spec, shape, mesh)
            except ValueError as ex:
                out[key] = {"skip": str(ex)}
                continue
            args = [[list(a.shape), str(a.dtype)]
                    for a in jax.tree.leaves(wl["args"])]
            specs = [[list(p) if isinstance(p, tuple) else p
                      for p in s.spec]
                     for s in jax.tree.leaves(wl["in_shardings"])]
            out[key] = {"args": args, "specs": specs,
                        "donate": list(wl.get("donate_argnums", ()))}
json.dump(out, open(sys.argv[1], "w"))
"""

_PORT_PROGRAM = """
import json, sys
import torch
from repro_torch.configs import ARCH_IDS, get
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.workloads import build_workload
from repro_torch.optim.adamw import _is_spec
from repro_torch.optim.tree import tree_leaves


def spec_leaves(tree):
    if _is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for item in tree for s in spec_leaves(item)]


out = {}
for kind, multi, n in (("single", False, 256), ("multi", True, 512)):
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch in ARCH_IDS:
            spec = get(arch)
            for shape in spec.shapes:
                key = f"{arch}/{shape}/{kind}"
                try:
                    wl = build_workload(spec, shape, mesh)
                except ValueError as ex:
                    out[key] = {"skip": str(ex)}
                    continue
                args = [[list(a.shape), str(a.dtype).replace("torch.", "")]
                        for a in tree_leaves(wl["args"])]
                specs = [[list(p) if isinstance(p, tuple) else p for p in s]
                         for s in spec_leaves(wl["in_shardings"])]
                out[key] = {"args": args, "specs": specs,
                            "donate": list(wl.get("donate_argnums", ()))}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's workloads, the port's), keyed ``arch/shape/mesh``."""
    out = tmp_path_factory.mktemp("workloads")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(out / side)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for side, code in (("jax", _JAX_PROGRAM), ("port", _PORT_PROGRAM))}
    try:
        for side, p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{side}: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return tuple(json.loads((out / side).read_text())
                 for side in ("jax", "port"))


def test_every_pair_is_built(both):
    want, got = both
    assert len(want) == 84
    assert set(got) == set(want)
    skips = [k for k, v in want.items() if "skip" in v]
    assert len(skips) == 10


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "graph"])
def test_workloads_match_reference(both, family):
    """Per family: the skip reasons, or every argument's shape, dtype and
    spec and the donated arguments."""
    from repro_torch.configs import get

    want, got = both
    keys = [k for k in want if get(k.split("/")[0]).family == family]
    assert keys
    for key in keys:
        assert got[key] == want[key], key
