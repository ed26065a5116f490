"""The port stands alone: importing ``repro_torch`` (every module of it) and
``chip_smoke``'s module graph pulls in neither JAX nor the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

#: modules that must be among those imported (the registries and the copied
#: host oracles hold no torch code of their own, so a stray import of the
#: JAX package would hide there first)
_NAMED = ("repro_torch.core.certs", "repro_torch.connectivity.host",
          "repro_torch.connectivity.registry", "repro_torch.core.api",
          "repro_torch.core.partition", "repro_torch.core.merge",
          "repro_torch.obs", "repro_torch.obs.tracer",
          "repro_torch.obs.metrics", "repro_torch.obs.profile",
          "repro_torch.core.bridges_device", "repro_torch.core.bridges_host",
          "repro_torch.graph.datastructs", "repro_torch.engine",
          "repro_torch.engine.state", "repro_torch.engine.dispatch",
          "repro_torch.engine.batched", "repro_torch.engine.engine",
          "repro_torch.engine.scheduler", "repro_torch.runtime",
          "repro_torch.runtime.watchdog", "repro_torch.runtime.failures",
          "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
          "repro_torch.launch", "repro_torch.launch.failover",
          "repro_torch.launch.serve_bridges",
          "repro_torch.core.baseline_savage_jaja",
          "repro_torch.configs", "repro_torch.configs.sasrec",
          "repro_torch.configs.bridges_dense",
          "repro_torch.data.pipeline", "repro_torch.interop",
          "repro_torch.kernels.embedding_bag.ops",
          "repro_torch.kernels.flash_attention.ops",
          "repro_torch.models.layers", "repro_torch.models.recsys",
          "repro_torch.models.transformer", "repro_torch.launch.mesh",
          "repro_torch.optim", "repro_torch.optim.adamw",
          "repro_torch.optim.compression", "repro_torch.optim.schedule",
          "repro_torch.optim.tree", "repro_torch.training.steps",
          "repro_torch.training", "repro_torch.launch.serve",
          "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.qwen3_14b",
          "repro_torch.configs.stablelm_12b", "repro_torch.models.moe",
          "repro_torch.launch.train", "repro_torch.configs.dbrx_132b",
          "repro_torch.configs.qwen3_moe_235b_a22b",
          "repro_torch.models.gnn", "repro_torch.models.pipeline",
          "repro_torch.data.sampler", "repro_torch.data",
          "repro_torch.configs.graphsage_reddit", "repro_torch.configs.pna",
          "repro_torch.configs.egnn", "repro_torch.configs.gatedgcn")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
for name in {named!r}:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("NAMED", all(name in sys.modules for name in {named!r}))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT), named=_NAMED)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert "NAMED True" in proc.stdout, proc.stdout
    loaded = int(proc.stdout.split("LOADED ")[1].split()[0])
    assert loaded >= 70  # every module of the package was imported
