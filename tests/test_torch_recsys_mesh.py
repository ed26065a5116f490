"""SASRec's multi-card branches over gloo, against the JAX package's
8-device ``shard_map`` programs.

One world of eight spawned CPU ranks (``tests/torch_recsys_world.py``) on
a (4, 2) ``("data", "model")`` mesh runs ``serve_scores``,
``serve_bulk_topk`` and ``retrieval_scores`` through the port's mesh
branches on the smoke weights placed by ``reshard_checkpoint`` with
``param_specs``, and ``compressed_psum_tree`` over the data axis with
error feedback; a subprocess with eight forced XLA host devices runs the
JAX package's programs on ``make_test_mesh(8)`` on the same inputs. A
second world of four ranks restores the tree that the eight ranks (and
JAX's eight devices) saved, onto a (2, 2) mesh, as
``tests/test_fault_tolerance.py::test_elastic_reshard_across_device_counts``
does.

Tolerance 1e-5 on scores (``test_torch_recsys.py``'s); top-k ids equal,
in ``lax.top_k``'s order, wherever neighbouring scores differ by more
than it. The compressed all-reduce: one float32 rounding (its test says
why). The elastic restore: equal.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_recsys_world as world_mod
from repro.configs import sasrec as j_sasrec
from repro.models import recsys as j_rec
from repro_torch.configs import sasrec
from repro_torch.data.pipeline import recsys_batches
from repro_torch.interop import sasrec_params_from_numpy
from repro_torch.models import recsys as rec

from helpers import requires_modern_sharding
from test_torch_recsys import TOL, _close, _same_topk

ROOT = Path(__file__).resolve().parents[1]
CFG = sasrec.SMOKE
K, N_CHUNKS = world_mod.K, world_mod.N_CHUNKS
SERVE, RESTORE = world_mod.SERVE_SHAPE, world_mod.RESTORE_SHAPE
B, C = 8, 64
#: each world's limit: a hang fails the test instead of stalling it
WORLD_TIMEOUT_S = 240

_JAX_PROGRAM = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint import CheckpointManager, reshard_checkpoint
from repro.configs.sasrec import SMOKE
from repro.launch.mesh import make_test_mesh
from repro.models import recsys as rec
from repro.models.transformer import Parallelism
from repro.optim.compression import compressed_psum_tree

inputs, out, ckpt = sys.argv[1:4]
K, N_CHUNKS = {k}, {n_chunks}
z = dict(np.load(inputs))
names = ("wq", "wk", "wv", "w1", "w2", "ln1", "ln2")
params = {{"item_emb": jnp.asarray(z["item_emb"]),
          "pos_emb": jnp.asarray(z["pos_emb"]),
          "blocks": [{{n: jnp.asarray(z[f"blocks/{{i}}/{{n}}"]) for n in names}}
                     for i in range(SMOKE.n_blocks)]}}
mesh = make_test_mesh(8)
par = Parallelism(mesh=mesh, dp_axes=("data",), tp_axis="model")
res = {{}}
spec = P(("data", "model"))
with jax.set_mesh(mesh):
    res["serve"] = jax.jit(lambda p, s: rec.serve_scores(p, s, SMOKE, par))(
        params, z["seq"])
    res["bulk_s"], res["bulk_i"] = jax.jit(lambda p, s: rec.serve_bulk_topk(
        p, s, SMOKE, par, k=K, n_chunks=N_CHUNKS))(params, z["seq"])
    res["retrieval"] = jax.jit(lambda p, h, m, c: rec.retrieval_scores(
        p, h, m, c, SMOKE, par))(params, z["history"], z["hist_mask"],
                                 z["candidates"])

    def body(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = None if e is None else jax.tree.map(lambda x: x[0], e)
        ng, ne = compressed_psum_tree(g, e, "data")
        return (jax.tree.map(lambda x: x[None], ng),
                jax.tree.map(lambda x: x[None], ne))

    errs = None
    for step in range(2):
        g = {{k: jnp.stack([z[f"grads/{{r}}/{{step}}/{{k}}"] for r in range(8)])
             for k in ("a", "b")}}
        if errs is None:
            fn = jax.shard_map(lambda g: body(g, None), mesh=mesh,
                               in_specs=(spec,), out_specs=(spec, spec),
                               check_vma=False)
            ng, errs = jax.jit(fn)(g)
        else:
            fn = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False)
            ng, errs = jax.jit(fn)(g, errs)
        for k in ("a", "b"):
            res[f"psum/{{step}}/g/{{k}}"] = ng[k]
            res[f"psum/{{step}}/e/{{k}}"] = errs[k]

tree = {{"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}}
sharded = reshard_checkpoint(tree, mesh, {{"w": P("data", "model")}})
CheckpointManager(ckpt).save(1, sharded)
np.savez(out, **{{k: np.asarray(v) for k, v in res.items()}})
"""


def _right_aligned(seq: np.ndarray) -> np.ndarray:
    """Each history moved to end at the last position (padding first)."""
    return np.stack([np.concatenate([r[r == 0], r[r != 0]]) for r in seq])


def _inputs(path: Path) -> dict:
    """The smoke weights (the JAX package's, key 0), B histories, two of
    them a retrieval batch, C candidates (one outside the table at each
    end, which the mesh branch scores 0), and two steps of gradients per
    mesh position."""
    jparams = j_rec.init_sasrec(j_sasrec.SMOKE, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(4)
    seq = _right_aligned(recsys_batches(CFG.n_items, B, CFG.seq_len,
                                        seed=5)(0)["seq"])
    cand = rng.integers(1, CFG.n_items, C).astype(np.int32)
    cand[:3] = [-1, 0, CFG.n_items]
    data = {"item_emb": tree["item_emb"], "pos_emb": tree["pos_emb"],
            "seq": seq, "history": seq[:2], "hist_mask": seq[:2] != 0,
            "candidates": cand}
    for i, blk in enumerate(tree["blocks"]):
        data.update({f"blocks/{i}/{k}": v for k, v in blk.items()})
    for row in range(8):
        for step in range(2):
            g = np.random.default_rng((row, step))
            data[f"grads/{row}/{step}/a"] = (g.normal(size=(5, 3))
                                             * (row + 1)).astype(np.float32)
            data[f"grads/{row}/{step}/b"] = g.normal(size=7).astype(
                np.float32)
    np.savez(path, **data)
    return data


def _spawn_world(phase: str, world: int, out: Path, inputs: Path) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    store = out / f"store-{phase}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_recsys_world.py"),
         "--phase", phase, "--rank", str(r), "--world", str(world),
         "--store", str(store), "--inputs", str(inputs), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the JAX program's outputs, the serve world's ranks, the
    restore world's ranks). The JAX subprocess runs beside the eight-rank
    world; the four-rank world restores what both saved."""
    out = tmp_path_factory.mktemp("recsys_world")
    inputs = out / "inputs.npz"
    data = _inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(_JAX_PROGRAM.format(k=K, n_chunks=N_CHUNKS))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", code, str(inputs), str(out / "jax.npz"),
         str(out / "jax_ckpt")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        _spawn_world("serve", 8, out, inputs)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    _spawn_world("restore", 4, out, inputs)

    def load(name):
        with np.load(out / name) as z:
            return dict(z)

    return (data, load("jax.npz"),
            [load(f"serve-rank{r}.npz") for r in range(8)],
            [load(f"restore-rank{r}.npz") for r in range(4)])


def _rows(x: np.ndarray, coord, parts: int) -> np.ndarray:
    """The data block of ``x`` along its first dimension at ``coord``."""
    n = x.shape[0] // parts
    return x[coord[0] * n:(coord[0] + 1) * n]


def test_mesh_coordinates_and_table_rows(run):
    data, _, ranks, _ = run
    coords = sorted(tuple(r["coord"]) for r in ranks)
    assert coords == [(d, m) for d in range(4) for m in range(2)]
    rows = CFG.n_items // SERVE[1]
    for r in ranks:
        m = r["coord"][1]
        assert np.array_equal(r["table_rows"],
                              data["item_emb"][m * rows:(m + 1) * rows])


@requires_modern_sharding
def test_serve_scores_block_matches_jax(run):
    _, want, ranks, _ = run
    rows = CFG.n_items // SERVE[1]
    for r in ranks:
        d, m = r["coord"]
        block = want["serve"][d * 2:(d + 1) * 2, m * rows:(m + 1) * rows]
        _close(r["serve"], block)


@requires_modern_sharding
@pytest.mark.parametrize("params", ["dtensor", "local"])
def test_serve_bulk_topk_matches_jax(run, params):
    _, want, ranks, _ = run
    key = "bulk" if params == "dtensor" else "bulk_local"
    for r in ranks:
        got_s = torch.from_numpy(r[f"{key}_s"])
        got_i = torch.from_numpy(r[f"{key}_i"])
        assert got_s.shape == (B // SERVE[0], K)
        _same_topk(got_s, got_i, _rows(want["bulk_s"], r["coord"], 4),
                   _rows(want["bulk_i"], r["coord"], 4))


def test_serve_bulk_topk_equals_the_meshless_shards(run):
    """The mesh branch's blocks are the meshless path's over the same two
    row shards (the port's own ``n_shards=2``)."""
    data, _, ranks, _ = run
    params = sasrec_params_from_numpy(
        {"item_emb": data["item_emb"], "pos_emb": data["pos_emb"],
         "blocks": [{k: data[f"blocks/{i}/{k}"]
                     for k in (*rec.BLOCK_MATRICES, "ln1", "ln2")}
                    for i in range(CFG.n_blocks)]}, CFG, device="cpu")
    s, i = rec.serve_bulk_topk(params, data["seq"], CFG, k=K,
                               n_chunks=N_CHUNKS, n_shards=SERVE[1])
    for r in ranks:
        _same_topk(torch.from_numpy(r["bulk_s"]),
                   torch.from_numpy(r["bulk_i"]),
                   _rows(s.numpy(), r["coord"], 4),
                   _rows(i.numpy(), r["coord"], 4))


@requires_modern_sharding
def test_retrieval_scores_block_matches_jax(run):
    _, want, ranks, _ = run
    assert np.isfinite(want["retrieval"]).all()
    assert (want["retrieval"][:, [0, 2]] == 0).all()  # outside the table
    per = C // SERVE[0]
    for r in ranks:
        d = r["coord"][0]
        assert r["retrieval"].shape == (2, per)
        _close(r["retrieval"], want["retrieval"][:, d * per:(d + 1) * per])


@requires_modern_sharding
@pytest.mark.parametrize("step", [0, 1])
def test_compressed_psum_tree_matches_jax(run, step):
    """Each rank's mean gradient and new error against the JAX device at
    its mesh position; the second step carries the first one's errors.
    Within 2^-22 of the leaf's largest input gradient over the group: XLA
    fuses ``g - q * scale`` into one multiply-add where ATen rounds
    ``q * scale`` first, a difference of one float32 rounding of a value
    no larger than that gradient (plus its error)."""
    data, want, ranks, _ = run
    for r in ranks:
        d, m = r["coord"]
        row = d * SERVE[1] + m
        group = [i * SERVE[1] + m for i in range(SERVE[0])]
        for key in ("a", "b"):
            amax = max(np.abs(data[f"grads/{i}/{step}/{key}"]).max()
                       for i in group)
            for part in ("g", "e"):
                name = f"psum/{step}/{part}/{key}"
                np.testing.assert_allclose(r[name], want[name][row], rtol=0,
                                           atol=amax * 2.0 ** -22,
                                           err_msg=f"{name} row {row}")


def test_compressed_psum_tree_is_the_data_group_mean(run):
    """Without errors the result is each model column's mean gradient over
    its four data ranks, within one step of the shared int8 grid."""
    data, _, ranks, _ = run
    for r in ranks:
        m = r["coord"][1]
        rows = [d * SERVE[1] + m for d in range(SERVE[0])]
        for key in ("a", "b"):
            g = np.stack([data[f"grads/{row}/0/{key}"] for row in rows])
            scale = np.abs(g).max() / 127
            np.testing.assert_allclose(r[f"psum/0/g/{key}"], g.mean(0),
                                       atol=scale * 0.51)


def test_elastic_blocks_under_eight_ranks(run):
    _, _, ranks, _ = run
    for r in ranks:
        d, m = r["coord"]
        assert np.array_equal(r["elastic_local"],
                              world_mod.ELASTIC[d * 2:(d + 1) * 2,
                                                m * 4:(m + 1) * 4])


@pytest.mark.parametrize("saved_by", ["ckpt", "jax_ckpt"])
def test_elastic_reshard_from_eight_onto_four(run, saved_by):
    """Saved under eight ranks (the port's world, or JAX's eight devices),
    restored and placed on four: every rank holds its block and the whole
    tree gathers back equal."""
    _, _, _, restored = run
    assert sorted(tuple(r["coord"]) for r in restored) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in restored:
        d, m = r["coord"]
        assert int(r["ranks"]) == 4
        assert int(r[f"{saved_by}/step"]) == 1
        assert np.array_equal(r[f"{saved_by}/full"], world_mod.ELASTIC)
        assert np.array_equal(r[f"{saved_by}/local"],
                              world_mod.ELASTIC[d * 4:(d + 1) * 4,
                                                m * 4:(m + 1) * 4])
