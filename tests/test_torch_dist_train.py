"""The sharded train steps on 4 gloo ranks against the JAX package (the
ranks run ``torch_dist_ranks.train_rank``; they import no JAX, this
process computes the reference side while they run and compares):

- ``build_train_step(mesh, rules)`` — FSDP over ``data``, tensor
  parallelism over ``model`` (local heads, kv heads replicated and
  selected where they do not split, vocab-parallel embedding and
  cross-entropy, FlexTree's combine at the row-parallel sites) — for
  smoke stablelm-1.6b, yi-9b (8 q / 2 kv heads) and gemma-2b (tied head,
  hd 16) on meshes (2, 2), (1, 4) and (4, 1), float32, 2 steps in 2
  microbatches under remat ``full``, against the reference's unsharded
  ``make_step_fn``: the loss and grad norm of each step, the gathered
  first and second moments after step 1 (the moments of the gathered
  gradient) and the gathered parameters after step 2;
- ``build_dp_compressed_step`` in ``int8`` and ``zvc_topk`` on a (2, 2)
  mesh: stablelm-1.6b for 2 steps against the reference-side composition
  (each rank's ``jax.value_and_grad`` on its rows, the reference's
  quantize / top-k with the error carry, the mean, the reference's
  AdamW), and one step of each other family (MoE, Griffin, SSM, Whisper
  with frames, the VLM with row-dependent M-RoPE streams) against the
  port's own composition on the ranks' rows;
- a sharded checkpoint and resume on (2, 2) equal to a straight run, the
  files holding the full leaves;
- ``launch.train --model-shards 2`` on the 4 ranks against one process.

Tolerances (float32; the two sides differ in the order of their sums):
losses rtol 1e-5 (the launcher's 3 steps 1e-4); grad norms rtol 1e-4;
moments within 1e-4·max|ref| + 1e-7 per leaf; parameters after AdamW
within 1e-5·max|ref| + 0.1·Σlr per leaf (AdamW moves an element by about
lr, and by an ill-conditioned ratio where the gradient is tiny); the
compressed steps' parameters the same for all but 1e-3 of a leaf's
elements and within 2·Σlr for those (``_close_flipped``), their error
carries within one int8 quantum (a rounding that flips) or, for top-k,
equal but where the mask flips at the threshold; the resume bit for
bit."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import base as ref_base
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_to_numpy
from repro_torch.data.pipeline import with_frontend_inputs
from repro_torch.launch import train as pt_launch
from repro_torch.models import model as pt_model
from repro_torch.train import grad_compress as pt_gc
from repro_torch.train import train_step as pt_step
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state, tree_leaves)

ARCHS = ("stablelm-1.6b", "yi-9b", "gemma-2b")
MESHES = ((2, 2), (1, 4), (4, 1))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
LR_SUM = 1e-3 * (1 / 2 + 2 / 2)          # the lr of steps 1 and 2
SHAPE = pt_base.ShapeConfig(name="t", kind="train", seq_len=32,
                            global_batch=8, loss_chunk=16, attn_chunk=16,
                            remat="full", n_micro=2)
DP_SHAPE = pt_base.ShapeConfig(name="dp", kind="train", seq_len=32,
                               global_batch=4, loss_chunk=16, attn_chunk=16,
                               remat="none")
DP_OTHERS = ("deepseek-moe-16b", "recurrentgemma-9b", "mamba2-1.3b",
             "whisper-tiny", "qwen2-vl-72b")
LAUNCH = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
          "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
          "100"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work (set back after):
    next to the suite's other workers and the spawned ranks, more threads
    only contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (b, 32)).astype(np.int32)
            for k in ("tokens", "labels")}


def _frontend(cfg, raw):
    out = with_frontend_inputs(raw, cfg, n_vis=pt_model.n_vis(cfg, 32))
    if "mrope_positions" in out:      # rows that differ, streams that differ
        b = raw["tokens"].shape[0]
        out["mrope_positions"] = (
            np.arange(32, dtype=np.int32)[None, None]
            + 7 * np.arange(b, dtype=np.int32)[None, :, None]
            * np.arange(1, 4, dtype=np.int32)[:, None, None])
    return out


def _inputs():
    train = {}
    for arch in ARCHS:
        cfg = pt_base.get_smoke_config(arch)
        p = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                 dtype=torch.float32, device="cpu")
        train[arch] = {"cfg": cfg, "params": params_to_numpy(p),
                       "batches": [_tokens(cfg, 8, s) for s in (1, 2)]}
    dp = {"stablelm-1.6b": {"cfg": train["stablelm-1.6b"]["cfg"],
                            "params": train["stablelm-1.6b"]["params"],
                            "batches": [_tokens(train["stablelm-1.6b"]["cfg"],
                                                4, s) for s in (3, 4)]}}
    for arch in DP_OTHERS:
        cfg = pt_base.get_smoke_config(arch)
        p = pt_model.init_params(cfg, torch.Generator().manual_seed(5),
                                 dtype=torch.float32, device="cpu")
        dp[arch] = {"cfg": cfg, "params": params_to_numpy(p),
                    "batches": [_frontend(cfg, _tokens(cfg, 4, 6))]}
    return {"train": train, "meshes": MESHES, "shape": SHAPE, "opt": OPT,
            "dp": dp, "dp_shape": DP_SHAPE,
            "dp_steps": {"stablelm-1.6b": 2, **{a: 1 for a in DP_OTHERS}},
            "launcher": LAUNCH + ["--model-shards", "2"]}


def _ref_train(inp, arch):
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


def _kept(mode):
    """Each leaf's (kept part, scale or threshold) of grad + error: the
    reference's quantize / dequantize, or its top-k mask."""
    def one(gl, el):
        u = gl + el
        if mode == "int8":
            q, s = ref_gc.quantize_int8(u)
            return ref_gc.dequantize_int8(q, s), s
        flat = u.reshape(-1)
        k = max(int(flat.shape[0] * 0.1), 1)
        thr = jax.lax.top_k(jnp.abs(flat), k)[0][-1]
        return jnp.where(jnp.abs(u) >= thr, u, 0.0), thr

    def tree(g, e):
        out = jax.tree.map(one, g, e)
        first = jax.tree.map(lambda o: o[0], out,
                             is_leaf=lambda o: isinstance(o, tuple))
        second = jax.tree.map(lambda o: o[1], out,
                              is_leaf=lambda o: isinstance(o, tuple))
        return first, second
    return jax.jit(tree)


def _ref_dp(inp, mode, grad):
    """The reference-side composition of the compressed DP step."""
    case = inp["dp"]["stablelm-1.6b"]
    kept_fn = _kept(mode)
    p = jax.tree.map(jnp.asarray, case["params"])
    st = ref_opt.init_opt_state(p)
    err = [ref_gc.init_error_state(p) for _ in range(4)]
    rec = []
    for b in case["batches"]:
        losses, kept, scales = [], [], []
        for r in range(4):
            loss, g = grad(p, {k: jnp.asarray(v[r:r + 1])
                               for k, v in b.items()})
            losses.append(float(loss))
            kr, sr = kept_fn(g, err[r])
            scales.append(sr)
            err[r] = jax.tree.map(lambda gl, el, kl: gl + el - kl, g, err[r],
                                  kr)
            kept.append(kr)
        mean = jax.tree.map(lambda *ks: sum(ks) / 4, *kept)
        p, st, _ = ref_opt.adamw_update(ref_opt.AdamWConfig(**OPT), p, mean,
                                        st)
        rec.append({"loss": float(np.mean(losses)), "params": p,
                    "err": err, "scales": scales})
    return rec


def _port_dp(inp, arch, mode):
    """The port's own composition of one compressed DP step, in this
    process, on each rank's rows."""
    case = inp["dp"][arch]
    cfg = case["cfg"]
    p = {k: v for k, v in ranks._params(case["params"]).items()}
    loss_fn = pt_step.loss_for(cfg, DP_SHAPE)
    b = case["batches"][0]
    means, losses = [], []
    for r in range(4):
        local = {k: torch.from_numpy(np.ascontiguousarray(
            v[:, r:r + 1] if k == "mrope_positions" else v[r:r + 1]))
            for k, v in b.items()}
        loss, g = pt_step.value_and_grad(loss_fn, p, local)
        losses.append(float(loss))
        cfg_c = pt_gc.CompressConfig(mode=mode, topk_frac=0.1)
        means.append([pt_gc.compressed_mean(x, torch.zeros_like(x), cfg_c)[0]
                      for x in tree_leaves(g)])
    mean = pt_step._unflatten(p, [sum(ms) / 4 for ms in zip(*means)])
    new, _, _ = adamw_update(AdamWConfig(**OPT), p, mean, init_opt_state(p))
    return float(np.mean(losses)), new


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_train"))
    inp = _inputs()
    ctx = ranks.spawn(ranks.train_rank, 4, d, inp)
    try:
        grad = jax.jit(jax.value_and_grad(ref_step.loss_for(
            ref_base.get_smoke_config("stablelm-1.6b"),
            ref_base.ShapeConfig(**dataclasses.asdict(DP_SHAPE)))))
        ref = {"train": {a: _ref_train(inp, a) for a in ARCHS},
               "dp": {m: _ref_dp(inp, m, grad) for m in ("int8", "zvc_topk")},
               "launcher": [r["loss"] for r in pt_launch.main(LAUNCH)]}
    finally:
        out = ranks.collect(ctx, d)
    return inp, ref, out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _close_tree(port, ref, rel, abs_):
    for path, r in _paths(ref).items():
        p = _np(_at(port, path))
        r = _np(r)
        assert p.shape == r.shape, path
        tol = rel * np.abs(r).max() + abs_
        assert np.abs(p - r).max() <= tol, (path, np.abs(p - r).max(), tol)


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


def _close_flipped(port, ref, lr_sum):
    """Parameters after compressed steps: an int8 rounding (or a top-k
    mask) that flips on one rank moves that element's mean gradient by a
    quantum / 4, which AdamW can turn into up to a step of lr where the
    gradient is small.  Every element within 1e-5·max|ref| + 2·Σlr, all
    but 1e-3 of each leaf's within 1e-5·max|ref| + 0.1·Σlr."""
    for path, r in _paths(ref).items():
        p, r = _np(_at(port, path)), _np(r)
        base = 1e-5 * np.abs(r).max()
        err = np.abs(p - r)
        assert err.max() <= base + 2 * lr_sum, (path, err.max())
        assert (err > base + 0.1 * lr_sum).mean() <= 1e-3, path


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference(run, arch, mesh):
    _, ref, out = run
    got, want = out["sharded"][(arch, mesh)], ref["train"][arch]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    _close_tree(got[0]["mu"], want[0]["mu"], 1e-4, 1e-7)
    _close_tree(got[0]["nu"], want[0]["nu"], 1e-4, 1e-12)
    _close_tree(got[1]["params"], want[1]["params"], 1e-5, 0.1 * LR_SUM)


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["int8", "zvc_topk"])
def test_dp_compressed_step_matches_the_reference(run, mode):
    _, ref, out = run
    got, want = out["dp"][("stablelm-1.6b", mode)], ref["dp"][mode]
    lr_sum = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        lr_sum += 1e-3 * (step + 1) / 2
        _close_flipped(g["params"], w["params"], lr_sum)
    # rank 0's error carry: within one quantum (int8) or equal but where
    # the top-k mask flips at the threshold
    err, werr, scales = got[-1]["err"], want[-1]["err"][0], \
        want[-1]["scales"][0]
    assert any(np.abs(_np(e)).max() > 0 for e in tree_leaves(err))
    for path, w in _paths(werr).items():
        e, w, s = _np(_at(err, path)), _np(w), float(_at(scales, path))
        diff = np.abs(e - w)
        if mode == "int8":
            assert diff.max() <= 1.01 * s + 1e-6 * np.abs(w).max(), path
        else:
            assert (diff > 1e-4 * np.abs(w).max() + 1e-9).mean() <= 0.01, path


@pytest.mark.timeout(180)
@pytest.mark.parametrize("mode", ["int8", "zvc_topk"])
@pytest.mark.parametrize("arch", DP_OTHERS)
def test_dp_compressed_step_runs_every_family(run, arch, mode):
    inp, _, out = run
    (got,) = out["dp"][(arch, mode)]
    loss, new = _port_dp(inp, arch, mode)
    assert np.isfinite(got["loss"])
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    _close_tree(got["params"], new, 1e-5, 0.1 * 1e-3 / 2)
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(got["err"]))


@pytest.mark.timeout(180)
def test_sharded_resume_equals_a_straight_run(run):
    inp, _, out = run
    res = out["resume"]
    assert res["steps"] == [3, 4]
    assert res["loss"][0] == res["loss"][1]
    for a, b in zip(tree_leaves(res["params"][0]),
                    tree_leaves(res["params"][1])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(res["mu"][0]), tree_leaves(res["mu"][1])):
        assert torch.equal(a, b)
    # rank 0 wrote the full leaves
    step_dir = os.path.join(res["ckpt"], "step_000000004")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        index = json.load(f)["index"]
    cfg = inp["train"]["stablelm-1.6b"]["cfg"]
    assert index["params/embed"]["shape"] == [cfg.vocab, cfg.d_model]
    assert index["params/stack/layers/attn/wkv"]["shape"] == [
        cfg.n_layers, cfg.d_model, 2 * cfg.n_kv_heads * cfg.head_dim]
    assert index["opt/.mu/stack/layers/mlp/w_out"]["shape"] == [
        cfg.n_layers, cfg.d_ff, cfg.d_model]


@pytest.mark.timeout(180)
def test_launcher_model_shards_2_on_4_ranks(run):
    _, ref, out = run
    assert len(out["launcher"]) == len(ref["launcher"]) == 3
    np.testing.assert_allclose(out["launcher"], ref["launcher"], rtol=1e-4)
