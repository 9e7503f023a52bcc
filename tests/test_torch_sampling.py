"""The port's threefry sampling (``repro_torch.models.prng``,
``model.sample_tokens``) against ``jax.random`` and the JAX package's
``sample_tokens``.

Keys, 32-bit random bits and uniforms are held bit for bit.  The Gumbel
noise -log(-log(u)) goes through two logs, and ``torch.log`` and XLA's log
may differ by an ulp; one log's error of an ulp relative becomes an
absolute error of about an ulp of |g| in the outer log, so Gumbel noise is
held within one ulp of its own magnitude plus 2⁻²³ (the float32 spacing at
1, for |g| near 0).  Sampled tokens are compared on pinned seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro_torch.models import model as pt_model
from repro_torch.models import prng

SEEDS = (0, 1, 2 ** 31 - 1, 2 ** 32 - 1)
POSITIONS = (0, 1, 37, 2 ** 20)
VOCABS = (1, 7, 128, 100352)          # 128: edge-tiny's vocab
TINY = np.finfo(np.float32).tiny


def _keys():
    """(jax keys (16, 2), port keys (16, 2)) of every (seed, position)
    pair, built key by key on the JAX side."""
    pairs = [(seed, pos) for seed in SEEDS for pos in POSITIONS]
    jk = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)),
                                       np.uint32(p)) for s, p in pairs])
    pk = prng.fold_in(prng.PRNGKey(torch.tensor([s for s, _ in pairs])),
                      torch.tensor([p for _, p in pairs]))
    return jk, pk


def gumbel_bound(g: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(g).astype(np.float32)) + 2.0 ** -23


def test_threefry_partitionable_flag():
    """The port implements JAX's partitionable bit layout; a JAX that
    changes the default shows up here, not as a stream mismatch."""
    assert jax.config.jax_threefry_partitionable is True


def test_keys_equal_jax():
    for seed in SEEDS:
        want = np.asarray(jax.random.PRNGKey(np.uint32(seed)), np.int64)
        got = prng.PRNGKey(torch.tensor([seed]))[0].numpy()
        assert np.array_equal(got, want), seed
    jk, pk = _keys()
    assert np.array_equal(pk.numpy(), np.asarray(jk, np.int64))


@pytest.mark.parametrize("v", VOCABS)
def test_random_bits_equal_jax(v):
    jk, pk = _keys()
    want = jax.vmap(lambda k: jax.random.bits(k, (v,), jnp.uint32))(jk)
    assert np.array_equal(prng.random_bits(pk, v).numpy(),
                          np.asarray(want, np.int64))


@pytest.mark.parametrize("v", VOCABS)
def test_uniform_equal_jax(v):
    jk, pk = _keys()
    for lo in (0.0, TINY):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (v,), jnp.float32, minval=lo, maxval=1.0))(jk))
        got = prng.uniform(pk, v, minval=float(lo)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), lo


@pytest.mark.parametrize("v", VOCABS)
def test_gumbel_within_an_ulp(v):
    jk, pk = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,), jnp.float32))(jk))
    got = prng.gumbel(pk, v).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= gumbel_bound(want)).all()


def _ref_sample(logits, temp, top_k, seeds, pos):
    return np.asarray(ref_model.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(seeds, jnp.int32),
        jnp.asarray(pos, jnp.int32)))


def _port_sample(logits, temp, top_k, seeds, pos):
    return pt_model.sample_tokens(
        torch.from_numpy(logits), torch.tensor(temp, dtype=torch.float32),
        torch.tensor(top_k), torch.tensor(seeds), torch.tensor(pos)).numpy()


def _rows(rng, v, b=6):
    return rng.standard_normal((b, v)).astype(np.float32) * 3


@pytest.mark.parametrize("v", (7, 128, 4096))
def test_sample_tokens_equal_reference(v):
    """Mixed temperatures, top_k 0, 1, 3, V-1, V and 2V, on pinned seeds
    and positions: the same tokens as the reference."""
    rng = np.random.default_rng(v)
    for trial in range(4):
        lg = _rows(rng, v)
        temp = [0.0, 0.5, 1.0, 0.8, 2.0, 1.3]
        top_k = [0, 1, 3, v - 1, v, 2 * v]
        seeds = [trial, 1, 7, 2 ** 31 - 1, -1, 42]
        pos = [0, 3, 37, 5, 2 ** 20, 11]
        args = (lg, temp, top_k, seeds, pos)
        got = _port_sample(*args)
        assert got.dtype == np.int32
        assert np.array_equal(got, _ref_sample(*args))


def test_top_k_keeps_ties_at_the_threshold():
    """Logits from a few levels, so many tie at the k-th value: every tied
    logit stays live (``torch.topk`` indices would drop some), and the
    tokens equal the reference's."""
    rng = np.random.default_rng(3)
    lg = rng.integers(0, 4, size=(4, 64)).astype(np.float32)
    k = [2, 5, 10, 1]
    seen = [set() for _ in range(4)]
    for p in range(200):
        args = (lg, [1.0] * 4, k, [9, 9, 9, 9], [p] * 4)
        got = _port_sample(*args)
        assert np.array_equal(got, _ref_sample(*args))
        for r in range(4):
            seen[r].add(int(got[r]))
    for r in range(4):
        thresh = np.sort(lg[r])[::-1][k[r] - 1]
        assert seen[r] <= set(np.nonzero(lg[r] >= thresh)[0])
        assert len(seen[r]) > k[r]       # more than k tokens: the ties


def test_temperature_zero_is_greedy():
    rng = np.random.default_rng(5)
    lg = _rows(rng, 128, b=8)
    lg[0, [3, 9]] = lg[0].max() + 1.0         # a tie: argmax takes the first
    got = _port_sample(lg, [0.0] * 8, [0, 5, 1, 128, 0, 0, 3, 0],
                       list(range(8)), [4] * 8)
    assert np.array_equal(got, np.argmax(lg, axis=-1))
    assert got[0] == 3


def test_neg_inf_rows():
    """A row of -inf but one entry picks that entry; an all -inf row picks
    0 on both sides."""
    lg = np.zeros((3, 16), np.float32)
    lg[0] = -np.inf
    lg[0, 11] = 2.0
    lg[1] = -np.inf
    lg[2, :8] = -np.inf
    args = (lg, [0.8, 1.0, 0.5], [0, 4, 3], [1, 2, 3], [0, 1, 2])
    got = _port_sample(*args)
    assert np.array_equal(got, _ref_sample(*args))
    assert got[0] == 11 and got[1] == 0 and got[2] >= 8
