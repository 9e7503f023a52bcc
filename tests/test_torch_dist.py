"""The port's collectives on gloo ranks against the reference's arithmetic
(the ranks run ``torch_dist_ranks.collectives_rank``; they import no JAX,
this process computes the reference side and compares):

- ``flextree.reduce_psum``'s three strategies at W = 4 equal the numpy sum
  of the ranks' partials (``scatter``: this rank's block of it, along
  dims 0 and 1); at W = 3 ``tree`` falls back to an all-reduce; every
  rank's all-reduced result is the same bits;
- the EF-int8 and ZVC top-k means equal the composition of the
  reference's ``quantize_int8`` / ``dequantize_int8`` (and top-k mask) on
  each rank's input; the error carry is the reference's bit for bit;
- the autograd adjoints of ``all_gather`` (a reduce-scatter),
  ``to_model`` (an all-reduce) and ``from_model`` (the identity);
- ``pipeline_apply`` at 4 and 2 stages with 3 microbatches equals the
  sequential layer loop of the reference's
  ``test_pipeline_matches_sequential``.

Tolerances: sums of the same float32 partials in another order within
1e-6·max|sum| (4 terms); the compressed means within 1e-6·max|mean| (the
same products, summed in another order); the pipeline within the
reference test's 2e-5.  Bits where stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.train import grad_compress as ref_gc

SHAPE = (12, 12)
L, D, B, N_MICRO = 8, 16, 12, 3


def _inputs(world):
    rng = np.random.default_rng(world)
    inp = {"x": rng.standard_normal((world,) + SHAPE).astype(np.float32),
           "g": rng.standard_normal((world, 40, 24)).astype(np.float32),
           "err": (rng.standard_normal((world, 40, 24)) * 0.01
                   ).astype(np.float32),
           "c": rng.standard_normal((SHAPE[0], SHAPE[1] * world)
                                    ).astype(np.float32)}
    if world == 4:
        inp["pipe"] = {
            "stages": (4, 2), "n_micro": N_MICRO,
            "params": {"w": (rng.standard_normal((L, D, D)) * 0.3
                             ).astype(np.float32),
                       "b": np.zeros((L, D), np.float32)},
            "x": rng.standard_normal((B, D)).astype(np.float32)}
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 4 ranks and one of 3, started together."""
    out = {}
    ctxs = {}
    for world in (4, 3):
        d = str(tmp_path_factory.mktemp(f"dist{world}"))
        out[world] = {"inputs": _inputs(world), "dir": d}
        ctxs[world] = ranks.spawn(ranks.collectives_rank, world, d,
                                  out[world]["inputs"])
    for world, ctx in ctxs.items():
        out[world]["out"] = ranks.collect(ctx, out[world]["dir"])
    return out


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.timeout(180)
@pytest.mark.parametrize("world", [4, 3])
@pytest.mark.parametrize("strategy", ["allreduce", "scatter", "tree"])
def test_reduce_psum_strategies_equal_the_sum(runs, world, strategy):
    run = runs[world]
    total = run["inputs"]["x"].sum(0)
    for dim in (0, 1):
        got = [t.numpy() for t in run["out"][(strategy, dim)]]
        if strategy == "scatter":
            blocks = np.split(total, world, axis=dim)
            for r in range(world):
                _close(got[r], blocks[r], 1e-6)
        else:
            for r in range(world):
                _close(got[r], total, 1e-6)
                assert got[r].tobytes() == got[0].tobytes()


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["int8", "zvc_topk"])
def test_compressed_means_equal_the_reference_composition(runs, mode):
    run = runs[4]
    g, err = run["inputs"]["g"], run["inputs"]["err"]
    means, errs = run["out"][mode]
    parts = []
    for r in range(4):
        u = jnp.asarray(g[r]) + jnp.asarray(err[r])
        if mode == "int8":
            q, s = ref_gc.quantize_int8(u)
            kept = ref_gc.dequantize_int8(q, s)
        else:
            flat = u.reshape(-1)
            k = max(int(flat.shape[0] * 0.1), 1)
            thr = jax.lax.top_k(jnp.abs(flat), k)[0][-1]
            kept = jnp.where(jnp.abs(u) >= thr, u, 0.0)
        parts.append(np.asarray(kept))
        np.testing.assert_array_equal(errs[r].numpy(), np.asarray(u - kept))
    want = np.sum(parts, axis=0) / 4
    for r in range(4):
        _close(means[r].numpy(), want, 1e-6)
        assert means[r].numpy().tobytes() == means[0].numpy().tobytes()


@pytest.mark.timeout(180)
@pytest.mark.parametrize("name", ["all_gather", "to_model", "from_model"])
def test_collective_adjoints(runs, name):
    run = runs[4]
    x, c = run["inputs"]["x"], run["inputs"]["c"]
    ys, gxs = run["out"][name]
    n = SHAPE[1]
    for r in range(4):
        y, gx = ys[r].numpy(), gxs[r].numpy()
        if name == "all_gather":        # y = [x_0 | x_1 | ...]
            np.testing.assert_array_equal(y, np.concatenate(list(x), 1))
            _close(gx, 4 * c[:, r * n:(r + 1) * n], 1e-6)
        elif name == "to_model":        # dx = Σ over ranks of their dy
            np.testing.assert_array_equal(y, x[r])
            _close(gx, sum(c[:, q * n:(q + 1) * n] for q in range(4)), 1e-6)
        else:                           # y = Σ x, dx = dy
            _close(y, x.sum(0), 1e-6)
            np.testing.assert_array_equal(gx, c[:, :n])


@pytest.mark.timeout(180)
@pytest.mark.parametrize("stages", [4, 2])
def test_pipeline_matches_sequential(runs, stages):
    pipe = runs[4]["inputs"]["pipe"]
    ref = jnp.asarray(pipe["x"])
    for i in range(L):
        ref = jnp.tanh(ref @ pipe["params"]["w"][i] + pipe["params"]["b"][i])
    for y in runs[4]["out"][("pipe", stages)]:
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
