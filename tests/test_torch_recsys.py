"""Port parity of SASRec's serving path on the CPU: the port's model and
steps against the JAX package's (``par=None``), at the smoke config
(2,048 items, d = 16, 2 blocks, sequence 12), with the JAX weights carried
across by ``interop.sasrec_params_from_numpy`` and the sequences drawn by
``recsys_batches`` (identical in both packages).

Tolerance 1e-5 on floats. Top-k ids must be equal wherever neighbouring
scores differ by more than the tolerance (near-ties: the two packages' float
sums may differ in the last place), and equal outright on exact ties: the
port's selection follows ``lax.top_k``'s order, IEEE total order with the
lower position first among equal values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import RECSYS_SHAPES as J_RECSYS_SHAPES
from repro.configs import sasrec as j_sasrec
from repro.data.pipeline import recsys_batches as j_recsys_batches
from repro.models import recsys as j_rec
from repro.training.steps import make_recsys_steps as j_make_steps
from repro_torch.configs import RECSYS_SHAPES
from repro_torch.configs import sasrec
from repro_torch.data.pipeline import recsys_batches
from repro_torch.interop import sasrec_params_from_numpy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import recsys as rec
from repro_torch.training.steps import make_recsys_steps

TOL = 1e-5
CFG = sasrec.SMOKE
J_CFG = j_sasrec.SMOKE


@pytest.fixture(scope="module")
def weights():
    """The JAX package's smoke weights and the port's copy of them."""
    jparams = j_rec.init_sasrec(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, sasrec_params_from_numpy(tree, CFG, device="cpu")


def _seq(batch=6, step=0):
    """Histories of ``recsys_batches``, each moved to end at the last
    position (padding first), as a served user's history is: the user
    state is the last position's, and a padded last position gives a zero
    state whose scores all tie."""
    seq = recsys_batches(CFG.n_items, batch, CFG.seq_len, seed=3)(step)["seq"]
    return np.stack([np.concatenate([r[r == 0], r[r != 0]]) for r in seq])


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def _same_topk(got_s, got_i, want_s, want_i):
    """Scores within the tolerance; ids equal wherever the score is apart
    from both neighbours by more than it (elsewhere ties may swap)."""
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    _close(got_s, want_s)
    assert got_i.dtype == torch.int32
    gap = np.abs(np.diff(want_s, axis=1)) > TOL
    apart = np.ones_like(want_s, bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    assert apart.mean() > 0.5  # the check has teeth
    assert np.array_equal(got_i.numpy()[apart], want_i[apart])


def test_configs_are_copies():
    for name in ("CONFIG", "SMOKE"):
        mine, theirs = getattr(sasrec, name), getattr(j_sasrec, name)
        theirs = dataclasses.asdict(theirs)
        assert theirs.pop("scan_unroll") is False  # the JAX dry-run's mode
        assert dataclasses.asdict(mine) == theirs
    assert sasrec.CONFIG.dtype == torch.float32
    assert RECSYS_SHAPES == J_RECSYS_SHAPES
    for field in ("arch_id", "family", "shapes", "skips", "notes"):
        assert getattr(sasrec.SPEC, field) == getattr(j_sasrec.SPEC, field)


@pytest.mark.parametrize("step", [0, 5])
def test_recsys_batches_are_copies(step):
    mine = recsys_batches(CFG.n_items, 8, CFG.seq_len, seed=3)(step)
    theirs = j_recsys_batches(CFG.n_items, 8, CFG.seq_len, seed=3)(step)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == np.int32
        assert np.array_equal(mine[key], theirs[key])


def test_params_from_numpy_key_for_key(weights):
    jparams, params = weights
    assert params.keys() == jparams.keys()
    for a, b in zip(params["blocks"], jparams["blocks"]):
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key].numpy(), np.asarray(b[key]))
    assert np.array_equal(params["item_emb"].numpy(),
                          np.asarray(jparams["item_emb"]))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError, match="item_emb"):
        sasrec_params_from_numpy(tree, sasrec.CONFIG, device="cpu")


def test_init_sasrec_shapes_and_seed():
    gen = torch.Generator().manual_seed(0)
    a = rec.init_sasrec(CFG, gen, device="cpu")
    b = rec.init_sasrec(CFG, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda x: x.shape, j_rec.init_sasrec(J_CFG, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), a) == jshapes
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    assert a["item_emb"].dtype == torch.float32
    assert abs(float(a["item_emb"].std()) - 0.02) < 2e-3


def test_sasrec_hidden_and_user_state(weights):
    jparams, params = weights
    seq = _seq()
    assert (seq == 0).any()  # padding is exercised
    _close(rec.sasrec_hidden(params, seq, CFG),
           j_rec.sasrec_hidden(jparams, jnp.asarray(seq), J_CFG))
    _close(rec.sasrec_user_state(params, seq, CFG),
           j_rec.sasrec_user_state(jparams, jnp.asarray(seq), J_CFG))


def test_serve_scores(weights):
    jparams, params = weights
    seq = _seq(step=1)
    got = rec.serve_scores(params, seq, CFG)
    assert got.shape == (6, CFG.n_items)
    _close(got, j_rec.serve_scores(jparams, jnp.asarray(seq), J_CFG))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_serve_bulk_topk(weights, n_shards):
    jparams, params = weights
    seq = _seq(step=2)
    want = j_rec.serve_bulk_topk(jparams, jnp.asarray(seq), J_CFG, None, k=10,
                                 n_chunks=8, n_shards=n_shards)
    got = rec.serve_bulk_topk(params, seq, CFG, k=10, n_chunks=8,
                              n_shards=n_shards)
    _same_topk(*got, *want)
    # the chunked scan is the full table's top-k
    full = rec.serve_scores(params, seq, CFG)
    _close(got[0], torch.topk(full, 10).values.numpy())


def test_serve_bulk_chunk_count_divides_rows(weights):
    """n_chunks that does not divide the rows drops to one that does
    (recsys.py's loop), 7 -> 4 over 2048 rows."""
    jparams, params = weights
    seq = _seq(step=4)
    want = j_rec.serve_bulk_topk(jparams, jnp.asarray(seq), J_CFG, None, k=5,
                                 n_chunks=7)
    _same_topk(*rec.serve_bulk_topk(params, seq, CFG, k=5, n_chunks=7), *want)


@pytest.mark.parametrize("k", [3, 8])
def test_top_k_follows_lax_order(k):
    """NaN first, +0.0 before -0.0, the lower position first on ties."""
    x = np.array([0., -0., 1., 0., -0., 1., np.nan, -np.inf], np.float32)
    want_s, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_s, got_i = rec.top_k(torch.as_tensor(x), k)
    assert got_i.tolist() == np.asarray(want_i).tolist()
    assert np.array_equal(got_s.numpy().view(np.int32),
                          np.asarray(want_s).view(np.int32))  # signed zeros


def test_top_k_rows_with_ties():
    """Rows of few distinct values, where ties cross the k-th place, beside
    rows of distinct values and rows with NaN (negative NaN, which
    ``lax.top_k`` ranks below -inf, too), batched."""
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 3, (7, 40)).astype(np.float32)
    x[1] = rng.normal(size=40)
    x[2] *= -0.0  # signed zeros only
    x[3, ::5] = np.nan
    x[4, :30] = np.nan
    x[6] = rng.normal(size=40)
    x[6, ::3] = np.uint32(0xFFC00000).view(np.float32)  # -NaN
    want_s, want_i = jax.lax.top_k(jnp.asarray(x), 17)
    got_s, got_i = rec.top_k(torch.as_tensor(x), 17)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_s.numpy().view(np.int32),
                          np.asarray(want_s).view(np.int32))


def test_serve_bulk_topk_ties_of_an_all_padding_history(weights):
    """An all-padding history gives a zero user state: every score is 0
    and the ids are the reference's, the lowest ids first."""
    jparams, params = weights
    seq = np.zeros((1, CFG.seq_len), np.int32)
    want_s, want_i = j_rec.serve_bulk_topk(jparams, jnp.asarray(seq), J_CFG,
                                           None, k=5, n_chunks=8)
    got_s, got_i = rec.serve_bulk_topk(params, seq, CFG, k=5, n_chunks=8)
    assert np.asarray(want_i).tolist() == [[0, 1, 2, 3, 4]]
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_s, want_s)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_serve_bulk_topk_ties_across_chunks_and_shards(weights, n_shards):
    """A table of 256 rows repeated 8 times: every score ties with 7 others
    that lie in other chunks (8 chunks of each shard) and other shards. The
    ids must be the reference's, in its order."""
    jparams, _ = weights
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["item_emb"] = np.tile(tree["item_emb"][:CFG.n_items // 8], (8, 1))
    params = sasrec_params_from_numpy(tree, CFG, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    seq = _seq(step=7)
    want_s, want_i = j_rec.serve_bulk_topk(jparams, jnp.asarray(seq), J_CFG,
                                           None, k=20, n_chunks=8,
                                           n_shards=n_shards)
    got_s, got_i = rec.serve_bulk_topk(params, seq, CFG, k=20, n_chunks=8,
                                       n_shards=n_shards)
    _close(got_s, want_s)
    want_s = np.asarray(want_s)
    # runs of 8 equal scores, each run apart from the next by more than
    # the tolerance, so the order of the runs is not a near-tie
    runs = want_s[:, ::8]
    assert (np.diff(want_s.reshape(len(seq), -1, 4), axis=-1) == 0).all()
    assert (np.abs(np.diff(runs, axis=1)) > TOL).all()
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))


def test_retrieval_scores(weights):
    jparams, params = weights
    seq = _seq(batch=2, step=3)
    mask = seq != 0
    cand = np.random.default_rng(0).integers(1, CFG.n_items, 64).astype(
        np.int32)
    reset_launch_counts()
    got = rec.retrieval_scores(params, seq, mask, cand, CFG)
    assert got.shape == (2, 64) and got.dtype == torch.float32
    assert launch_counts()["embedding_bag"] == 0  # the CPU runs the plain one
    _close(got, j_rec.retrieval_scores(jparams, jnp.asarray(seq),
                                       jnp.asarray(mask), jnp.asarray(cand),
                                       J_CFG))


def test_make_recsys_steps(weights):
    """Each of the three serving steps against the JAX package's, as
    tests/test_arch_smoke.py drives them; the train step is held in
    tests/test_torch_training.py."""
    jparams, params = weights
    steps = make_recsys_steps(CFG)
    jsteps = j_make_steps(J_CFG, None)
    assert set(steps) == set(jsteps) == {"train", "serve", "bulk",
                                         "retrieval"}
    seq = _seq(batch=4, step=6)
    _close(steps["serve"](params, seq), jsteps["serve"](jparams,
                                                        jnp.asarray(seq)))
    _same_topk(*steps["bulk"](params, seq),
               *jsteps["bulk"](jparams, jnp.asarray(seq)))
    cand = np.arange(1, 65, dtype=np.int32)
    ones = np.ones((1, CFG.seq_len), bool)
    _close(steps["retrieval"](params, seq[:1], ones, cand),
           jsteps["retrieval"](jparams, jnp.asarray(seq[:1]),
                               jnp.asarray(ones), jnp.asarray(cand)))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec.init_sasrec(CFG, torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(
        np.asarray, j_rec.init_sasrec(J_CFG, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sasrec_params_from_numpy(tree, CFG)
