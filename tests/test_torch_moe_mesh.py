"""The mixture-of-experts layer's mesh branch over gloo, against the JAX
package's 8-device ``shard_map`` program.

Eight spawned CPU ranks (``tests/torch_moe_world.py``) on a (4, 2)
``("data", "model")`` mesh run ``make_moe_layer(mesh, ("data",),
"model", cfg)`` on the whole batch and the full expert weights; a
subprocess with eight forced XLA host devices runs the reference's
``make_moe_layer`` on ``make_test_mesh(8)`` on the same inputs. Each
rank's block of the output (its data coordinate's two sequences) is held
against the reference's rows, and every rank's aux against the
reference's. Two cases: eight experts, and four with capacity factor
0.5 (drops). x and the router lie on a grid of 2^-4, so the routing is
exact on both sides (``test_torch_moe.py``).

Tolerances: the output within 1e-5 of its largest magnitude (the
all-reduce over the two model ranks adds the partials in another order
than XLA's psum may), aux within 1e-6 relative (averaged over the model
ranks, then over the data ranks). A call under autograd raises.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_moe_world as world_mod

from helpers import requires_modern_sharding

ROOT = Path(__file__).resolve().parents[1]
B, S, D = 8, 6, 32
WORLD_TIMEOUT_S = 240
TOL = 1e-5

_JAX_PROGRAM = """
import sys
import numpy as np
import jax
from repro.launch.mesh import make_test_mesh
from repro.models.moe import MoEConfig, make_moe_layer

inputs, out = sys.argv[1:3]
cases = {cases!r}
z = dict(np.load(inputs))
mesh = make_test_mesh(8)
res = {{}}
with jax.set_mesh(mesh):
    for name, kw in cases.items():
        layer = make_moe_layer(mesh, ("data",), "model", MoEConfig(**kw))
        y, aux = jax.jit(layer)(*(z[f"{{name}}/{{a}}"] for a in {arrays!r}))
        res[f"{{name}}/out"], res[f"{{name}}/aux"] = y, aux
np.savez(out, **{{k: np.asarray(v) for k, v in res.items()}})
"""


def _grid(rng, shape):
    return (np.clip(np.round(rng.standard_normal(shape) * 4), -16, 16)
            / 16).astype(np.float32)


def _inputs(path: Path) -> dict:
    data = {}
    for i, (name, kw) in enumerate(world_mod.CASES.items()):
        rng = np.random.default_rng(i)
        e, f = kw["n_experts"], kw["d_ff_expert"]
        data[f"{name}/x"] = _grid(rng, (B, S, D))
        data[f"{name}/router"] = _grid(rng, (D, e))
        for w, shape, fan in (("we_gate", (e, D, f), D),
                              ("we_in", (e, D, f), D),
                              ("we_out", (e, f, D), f)):
            data[f"{name}/{w}"] = (rng.standard_normal(shape)
                                   / np.sqrt(fan)).astype(np.float32)
    np.savez(path, **data)
    return data


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX program's outputs, the eight ranks' files)."""
    out = tmp_path_factory.mktemp("moe_world")
    inputs = out / "inputs.npz"
    _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX_PROGRAM.format(cases=world_mod.CASES,
                                               arrays=world_mod.ARRAYS))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", code, str(inputs), str(out / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    wenv = dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_moe_world.py"),
         "--rank", str(r), "--world", "8", "--store", str(out / "store"),
         "--inputs", str(inputs), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=wenv)
        for r in range(8)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: {err[-2000:]}")
        _, jerr = jax_proc.communicate(timeout=600)
    finally:
        for p in [*procs, jax_proc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    assert jax_proc.returncode == 0, jerr[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return dict(np.load(out / "jax.npz")), ranks


@requires_modern_sharding
@pytest.mark.parametrize("case", list(world_mod.CASES))
def test_mesh_layer_matches_shard_map(run, case):
    want, ranks = run
    per = B // world_mod.SHAPE[0]
    for rank in ranks:
        data_i = int(rank["coord"][0])
        got = rank[f"{case}/out"]
        block = want[f"{case}/out"][data_i * per:(data_i + 1) * per]
        assert got.shape == block.shape == (per, S, D)
        scale = float(np.abs(block).max())
        assert float(np.abs(got - block).max()) <= TOL * scale
        np.testing.assert_allclose(float(rank[f"{case}/aux"]),
                                   float(want[f"{case}/aux"]), rtol=1e-6)


def test_mesh_branch_refuses_a_gradient(run):
    _, ranks = run
    for rank in ranks:
        assert "11.6" in str(rank["grad_raised"])
