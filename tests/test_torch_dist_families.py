"""Expert parallelism and the sharded train step of every family but the
dense one, on 4 gloo ranks against the JAX package.  The ranks run
``torch_dist_ranks.families_rank`` (no JAX there); this process computes
the reference's unsharded steps while they run, and the reference's
sharded functions run in a subprocess on 4 forced host devices under an
``Auto`` mesh (``torch_ref_sharded``, which edits nothing of the
package).  Float32 smoke configs throughout:

- ``collectives.all_to_all`` forward and backward along dims 0 and 1
  against the exchange done by hand, and ``collectives.fetch_columns``
  (each rank's columns of a leaf cut in column blocks, some used by
  every rank) against indexing the whole leaf, its gradient summed at
  each column's owner;
- ``apply_moe`` under the rules of (2, 2) and (1, 4) — the expert-
  parallel path, each shard dropping against its own capacities at the
  smoke capacity factor 1.25 — for deepseek-moe-16b (top-2, a shared
  expert) and llama4-scout (top-1) against the reference's sharded
  ``apply_moe``: y and the gradients of x, the router and every expert
  and shared leaf, rtol 1e-5 (llama4's top-1 gate is p / p = 1, so its
  router's gradient is rounding noise on both sides: both within 1e-5 of
  the largest dx); the reference's sharded output must differ
  from its unsharded one (tokens were dropped), else the case would not
  cover the per-shard capacities;
- ``apply_moe`` where ``_ep_applicable`` is false at a model axis above
  1 — at model 4 on a sequence of 6, and on (2, 2) with a batch of 3 that
  the data axis does not divide (every rank holds the whole batch) — the
  experts gathered, the local path replicated, against the reference's;
- ``build_train_step(mesh, rules)`` of deepseek-moe-16b, llama4-scout,
  recurrentgemma-9b, mamba2-1.3b, whisper-tiny (frames) and qwen2-vl-72b
  (a vision prefix, M-RoPE streams that differ by row) on (2, 2) and
  (1, 4), 2 steps in 2 microbatches under remat ``full``: the MoE configs
  against the reference's sharded step, the others against its unsharded
  ``make_step_fn`` (GSPMD keeps their arithmetic), under
  ``test_torch_dist_train.py``'s tolerances;
- ``launch.train --smoke --model-shards 2`` for deepseek-moe-16b on the 4
  ranks equal to the same steps built directly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
import torch_ref_sharded as ref_sharded
from repro.configs import base as ref_base
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_to_numpy
from repro_torch.data.pipeline import with_frontend_inputs
from repro_torch.models import model as pt_model
from repro_torch.models import moe as pt_moe

MOE = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
ARCHS = MOE + ("recurrentgemma-9b", "mamba2-1.3b", "whisper-tiny",
               "qwen2-vl-72b")
MESHES = ((2, 2), (1, 4))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
LR_SUM = 1e-3 * (1 / 2 + 2 / 2)          # the lr of steps 1 and 2
SHAPE = pt_base.ShapeConfig(name="t", kind="train", seq_len=32,
                            global_batch=8, loss_chunk=16, attn_chunk=16,
                            remat="full", n_micro=2)
MOE_X = (4, 32)                          # (B, S) of the apply_moe cases
NO_EP = {"seq": ("deepseek-moe-16b", (1, 4), (4, 6)),
         "batch": ("deepseek-moe-16b", (2, 2), (3, 32))}
LAUNCH = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
          "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
          "100", "--model-shards", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (set back after)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(cfg, seed):
    """8 rows of tokens and labels with the config's frontend inputs; a
    VLM's M-RoPE streams differ by row and by stream."""
    rng = np.random.default_rng(seed)
    raw = {k: rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
           for k in ("tokens", "labels")}
    out = with_frontend_inputs(raw, cfg, n_vis=pt_model.n_vis(cfg, 32))
    if "mrope_positions" in out:
        out["mrope_positions"] = (
            np.arange(32, dtype=np.int32)[None, None]
            + 7 * np.arange(8, dtype=np.int32)[None, :, None]
            * np.arange(1, 4, dtype=np.int32)[:, None, None])
    return out


def _moe_case(arch, mesh, bs, seed):
    cfg = pt_base.get_smoke_config(arch)
    p = pt_moe.init_moe(cfg, torch.Generator().manual_seed(seed),
                        dtype=torch.float32)
    rng = np.random.default_rng(seed)
    # one offset shared by every token skews the routing: shards overflow
    x = (rng.standard_normal(bs + (cfg.d_model,))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    return {"arch": arch, "cfg": cfg, "mesh": mesh,
            "params": params_to_numpy(p), "x": x, "gy": gy}


def _inputs():
    rng = np.random.default_rng(0)
    a2a = {"x": rng.standard_normal((4, 8, 12)).astype(np.float32),
           "c": {0: rng.standard_normal((4, 8, 12)).astype(np.float32),
                 1: rng.standard_normal((4, 8, 12)).astype(np.float32)}}
    # columns 0-15 in blocks of 4; 14 and 15 are used by every rank
    want = [np.array(sorted({4 * r, 4 * r + 1, 4 * ((r + 1) % 4) + 2, 14,
                             15}), np.int64) for r in range(4)]
    fetch = {"w": rng.standard_normal((6, 16)).astype(np.float32),
             "want": want,
             "c": [rng.standard_normal((6, len(w))).astype(np.float32)
                   for w in want]}
    moe = {(arch, mesh): _moe_case(arch, mesh, MOE_X, 11)
           for arch in MOE for mesh in MESHES}
    for name, (arch, mesh, bs) in NO_EP.items():
        moe[name] = _moe_case(arch, mesh, bs, 12)
    train = {}
    for arch in ARCHS:
        cfg = pt_base.get_smoke_config(arch)
        p = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                 dtype=torch.float32, device="cpu")
        train[arch] = {"cfg": cfg, "params": params_to_numpy(p),
                       "batches": [_batch(cfg, s) for s in (1, 2)]}
    return {"a2a": a2a, "fetch": fetch, "moe": moe, "train": train,
            "meshes": MESHES, "shape": SHAPE, "opt": OPT, "launcher": LAUNCH}


def _ref_inputs(inp):
    """What the reference's sharded side runs: every apply_moe case (the
    EP ones also unsharded) and the MoE configs' sharded steps."""
    moe = {k: {**{n: c[n] for n in ("arch", "mesh", "params", "x", "gy")},
               "local": k not in NO_EP} for k, c in inp["moe"].items()}
    shape = {**dataclasses.asdict(SHAPE), "remat": "none"}
    steps = {(arch, mesh): {"arch": arch, "mesh": mesh, "shape": shape,
                            "opt": OPT,
                            "params": inp["train"][arch]["params"],
                            "batches": inp["train"][arch]["batches"]}
             for arch in MOE for mesh in MESHES}
    return {"moe": moe, "steps": steps}


def _ref_unsharded(inp, arch):
    case = inp["train"][arch]
    rshape = ref_base.ShapeConfig(**{**dataclasses.asdict(SHAPE),
                                     "remat": "none"})
    step = jax.jit(ref_step.make_step_fn(ref_base.get_smoke_config(arch),
                                         rshape, ref_opt.AdamWConfig(**OPT)))
    p = jax.tree.map(jnp.asarray, case["params"])
    st = ref_opt.init_opt_state(p)
    rec = []
    for b in case["batches"]:
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": p, "mu": st.mu, "nu": st.nu})
    return rec


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_families"))
    inp = _inputs()
    ctx = ranks.spawn(ranks.families_rank, 4, d, inp)
    proc = None
    try:
        proc = ref_sharded.start(d, _ref_inputs(inp))
        ref = {a: _ref_unsharded(inp, a) for a in ARCHS if a not in MOE}
    finally:
        try:
            sharded = (ref_sharded.finish(proc, d, timeout=400.0)
                       if proc is not None else None)
        finally:
            out = ranks.collect(ctx, d, timeout=400.0)
    for (arch, mesh), rec in sharded["steps"].items():
        ref[(arch, mesh)] = rec
    return inp, ref, sharded, out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _close_tree(port, ref, rel, abs_):
    for path, r in _paths(ref).items():
        p, r = _np(_at(port, path)), _np(r)
        assert p.shape == r.shape, path
        tol = rel * np.abs(r).max() + abs_
        assert np.abs(p - r).max() <= tol, (path, np.abs(p - r).max(), tol)


def _close(port, ref, rtol=1e-5):
    """Within rtol of the reference's largest magnitude (float32 sums in
    another order)."""
    p, r = _np(port), _np(ref)
    assert p.shape == r.shape
    assert np.abs(p - r).max() <= rtol * np.abs(r).max() + 1e-7, \
        np.abs(p - r).max()


@pytest.mark.timeout(240)
@pytest.mark.parametrize("dim", [0, 1])
def test_all_to_all_matches_the_exchange_by_hand(run, dim):
    inp, _, _, out = run
    x, c = inp["a2a"]["x"], inp["a2a"]["c"][dim]
    ys, gxs = out["a2a"][dim]

    def chunks(t):
        return np.split(t, 4, axis=dim)
    for r in range(4):
        want_y = np.concatenate([chunks(x[s])[r] for s in range(4)], dim)
        want_g = np.concatenate([chunks(c[s])[r] for s in range(4)], dim)
        np.testing.assert_array_equal(ys[r].numpy(), want_y)
        np.testing.assert_array_equal(gxs[r].numpy(), want_g)


@pytest.mark.timeout(240)
def test_fetch_columns_matches_indexing_the_whole_leaf(run):
    inp, _, _, out = run
    f = inp["fetch"]
    w, want, c = f["w"], f["want"], f["c"]
    ys, gxs = out["fetch"]
    g = np.zeros_like(w)
    for r in range(4):
        np.testing.assert_array_equal(ys[r].numpy(), w[:, want[r]])
        g[:, want[r]] += c[r]
    for q in range(4):
        np.testing.assert_allclose(gxs[q].numpy(), g[:, 4 * q:4 * q + 4],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", MOE)
def test_ep_apply_moe_matches_the_reference(run, arch, mesh):
    _, _, sharded, out = run
    want, local = (sharded["moe"][(arch, mesh)][k]
                   for k in ("sharded", "local"))
    got = out["moe"][(arch, mesh)]
    assert got["ep"] and bool(want["ep"])
    # tokens were dropped: the sharded layer is not the unsharded one
    assert np.abs(want["y"] - local["y"]).max() > 1e-3
    _close(got["y"], want["y"])
    _close(got["gx"], want["gx"])
    for path, w in _paths(want["gp"]).items():
        g = _at(got["gp"], path)
        if path == "router" and pt_base.get_smoke_config(arch).moe.top_k == 1:
            # a top-1 gate is p / p = 1: the router's gradient is zero but
            # for rounding, on both sides — held to the layer's scale
            scale = np.abs(_np(want["gx"])).max()
            assert max(np.abs(_np(g)).max(), np.abs(w).max()) <= 1e-5 * scale
            continue
        _close(g, w)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", sorted(NO_EP))
def test_apply_moe_without_ep_matches_the_reference(run, case):
    _, _, sharded, out = run
    want, got = sharded["moe"][case]["sharded"], out["moe"][case]
    assert not got["ep"] and not bool(want["ep"])
    _close(got["y"], want["y"])
    _close(got["gx"], want["gx"])
    for path, w in _paths(want["gp"]).items():
        _close(_at(got["gp"], path), w)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference(run, arch, mesh):
    _, ref, _, out = run
    got = out["sharded"][(arch, mesh)]
    want = ref[(arch, mesh)] if arch in MOE else ref[arch]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=1e-5)
        assert g["grad_norm"] == pytest.approx(float(w["grad_norm"]),
                                               rel=1e-4)
    _close_tree(got[0]["mu"], want[0]["mu"], 1e-4, 1e-7)
    _close_tree(got[0]["nu"], want[0]["nu"], 1e-4, 1e-12)
    _close_tree(got[1]["params"], want[1]["params"], 1e-5, 0.1 * LR_SUM)


@pytest.mark.timeout(240)
def test_launcher_model_shards_2_equals_the_steps_built_directly(run):
    _, _, _, out = run
    launched, direct = out["launcher"]
    assert len(launched) == len(direct) == 3
    assert all(np.isfinite(launched))
    assert launched == direct
