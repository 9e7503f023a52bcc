"""Training in the port against the JAX package: the optimizer, the chunked
cross-entropy, whole-model gradients of ``train_loss`` (the flash branch's
plain backward among them), the ``ops`` routes under autograd, the
microbatched train step, remat, the data pipeline, the trainer's resume
and watchdog, and the launcher — smoke sizes, float32, numpy seeds; the
reference runs as its own tests run it (plain jnp paths under
``jax.value_and_grad``, no ExecConfig).

Tolerances (float32 on both sides; the two differ only in the order of
their sums):
- schedule, clipping and AdamW on the same trees: rtol 1e-6, atol 1e-7;
- loss values: rtol 1e-5; gradients of the loss and of the whole model:
  |port − ref| ≤ 1e-4·max|ref| + 1e-7 per leaf (the backward sums over
  every row of the batch and through every layer, each in its own order);
- the train step: params and moments ≤ 1e-5·max|ref| + 1e-7, loss rtol
  1e-5, grad_norm rtol 1e-4, lr rtol 1e-6; with ``grad_dtype="bf16"``
  the gradients are rounded to bf16 before AdamW, where a float32 sum that
  differs in its last bits can round to the neighbouring bf16 value and
  the first moment moves by up to 2⁻⁸ of a gradient: moments ≤ 2⁻⁷·max
  (grad_norm rtol 2⁻⁷).  Parameters after AdamW are held in units of the
  steps taken (``close_params``): AdamW's update is ill-conditioned where
  a gradient is tiny or its steps cancel.
Remat variants, pipeline batches and the ``ops`` routes' CPU gradients
against autograd of the same plain product are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipe
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import base as pt_base
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.sparsity import PlannedWeight
from repro_torch.data import pipeline as pt_pipe
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import layers as pt_layers
from repro_torch.models import model as pt_model
from repro_torch.quant.quantize import QuantizedLinear
from repro_torch.serve import engine as pt_engine
from repro_torch.train import optimizer as pt_opt
from repro_torch.train import train_step as pt_step
from repro_torch.train.trainer import (Trainer, TrainerConfig, Watchdog,
                                       WatchdogConfig)

SHAPE = pt_base.ShapeConfig(name="t", kind="train", seq_len=32,
                            global_batch=4, loss_chunk=16, attn_chunk=16,
                            remat="none")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def ref_shape(shape):
    return ref_base.ShapeConfig(**dataclasses.asdict(shape))


_CACHE = {}


def setup(arch):
    """(port cfg, ref cfg, ref float32 params, port params on the CPU)."""
    if arch not in _CACHE:
        cfg = pt_base.get_smoke_config(arch)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _CACHE[arch] = (cfg, rcfg, rp, pp)
    return _CACHE[arch]


def batch_np(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close_tree(port, ref, rel, abs_=1e-7):
    """Every leaf of the port's tree within rel·max|ref| + abs_ of the
    reference's (same structure, the port's as nested dicts)."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for kp, leaf in flat:
        node = port
        for k in kp:
            node = node[k.key]
        r, p = _np(leaf), _np(node)
        assert p.shape == r.shape, kp
        tol = rel * np.abs(r).max() + abs_
        err = np.abs(p - r).max()
        assert err <= tol, (jax.tree_util.keystr(kp), err, tol)


def close_params(port, ref, rel, lr_sum):
    """Parameters after AdamW steps, in units of the steps taken (Σlr):
    every element within rel·max|ref| + 0.1·Σlr, all but 1e-3 of each
    leaf's elements within rel·max|ref| + 0.01·Σlr.  AdamW moves an element
    by lr·m̂/(√v̂ + ε), and where a gradient is tiny or its steps cancel
    the two sides' last-bit differences move that ratio visibly, for those
    few elements only (measured: at most 0.05 of a step in float32, on
    1.2e-4 of one leaf's elements; 0.005 with bf16 gradients)."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for kp, leaf in flat:
        node = port
        for k in kp:
            node = node[k.key]
        r, p = _np(leaf), _np(node)
        base = rel * np.abs(r).max()
        err = np.abs(p - r)
        name = jax.tree_util.keystr(kp)
        assert err.max() <= base + 0.1 * lr_sum, (name, err.max())
        share = (err > base + 0.01 * lr_sum).mean()
        assert share <= 1e-3, (name, share)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(6, 5)).astype(dtype),
                  "scale": rng.normal(size=(5,)).astype(dtype)},
            "b": rng.normal(size=(3, 4, 2)).astype(dtype)}


def _pt(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 110, 200])
def test_cosine_lr_equals_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    ref = ref_opt.cosine_lr(ref_opt.AdamWConfig(**cfg), jnp.asarray(step))
    got = pt_opt.cosine_lr(pt_opt.AdamWConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clip_by_global_norm_equals_reference(max_norm):
    g = _tree(1)
    rc, rn = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm)
    pc, pn = pt_opt.clip_by_global_norm(_pt(g), max_norm)
    np.testing.assert_allclose(pn.item(), float(rn), rtol=1e-6)
    close_tree(pc, rc, 1e-6)


def test_adamw_three_steps_equal_reference():
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, warmup_steps=1,
               total_steps=10)
    params = _tree(2)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_opt.init_opt_state(rp)
    pp = _pt(params)
    ps = pt_opt.init_opt_state(pp)
    for i in range(3):
        g = _tree(10 + i)
        rp, rs, rm = ref_opt.adamw_update(ref_opt.AdamWConfig(**cfg), rp,
                                          jax.tree.map(jnp.asarray, g), rs)
        pp, ps, pm = pt_opt.adamw_update(pt_opt.AdamWConfig(**cfg), pp,
                                         _pt(g), ps)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(pm[k].item(), float(rm[k]),
                                       rtol=1e-6)
    assert int(ps.step) == int(rs.step) == 3
    close_tree(pp, rp, 1e-6)
    close_tree(ps.mu, rs.mu, 1e-6)
    close_tree(ps.nu, rs.nu, 1e-6)


def test_adamw_decays_matrices_only():
    cfg = pt_opt.AdamWConfig(lr=1e-2, weight_decay=1.0, clip_norm=1e9,
                             warmup_steps=1)
    params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,)),
              "stack": torch.ones((2, 4, 4), dtype=torch.bfloat16)}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new, st, _ = pt_opt.adamw_update(cfg, params, grads,
                                     pt_opt.init_opt_state(params))
    assert float(new["w"][0, 0]) < 1.0            # decayed
    assert float(new["stack"][0, 0, 0]) < 1.0     # decayed, bf16 kept
    assert new["stack"].dtype == torch.bfloat16
    assert float(new["scale"][0]) == 1.0          # not decayed
    assert all(m.dtype == torch.float32 for m in st.mu.values())


# ---------------------------------------------------------------------------
# loss and whole-model gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(48, 16), (40, 16), (8, 16)])
def test_chunked_softmax_xent_value_and_grad(s, chunk):
    """Including a tail that does not divide (40 = 2·16 + 8, dropped) and a
    chunk longer than the sequence."""
    cfg, rcfg, _, _ = setup("stablelm-1.6b")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    head = (rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.1).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    rl, (rgx, rgh) = jax.value_and_grad(
        lambda a, h: ref_layers.chunked_softmax_xent(
            rcfg, h, a, jnp.asarray(labels), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    pl = pt_layers.chunked_softmax_xent(cfg, th, tx, torch.from_numpy(labels),
                                        chunk=chunk)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-5)
    for got, ref in ((tx.grad, rgx), (th.grad, rgh)):
        r = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-7)


def _model_grads(arch, b, s, chunk, attn_chunk, remat="none"):
    cfg, rcfg, rp, pp = setup(arch)
    batch = batch_np(cfg, b, s, seed=4)
    rl, rg = jax.value_and_grad(
        lambda p: ref_model.train_loss(p, rcfg, to_ref(batch), remat=remat,
                                       loss_chunk=chunk, q_chunk=attn_chunk)
    )(rp)
    fn = pt_step.loss_for(cfg, dataclasses.replace(
        SHAPE, seq_len=s, global_batch=b, loss_chunk=chunk,
        attn_chunk=attn_chunk, remat=remat))
    pl, pg = pt_step.value_and_grad(fn, pp, to_port(batch))
    return pl, pg, rl, rg


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-2b"])
def test_train_loss_and_grads_equal_reference(arch):
    """Every leaf's gradient; gemma-2b ties the head to the embedding and
    has one kv head (MQA)."""
    pl, pg, rl, rg = _model_grads(arch, 2, 32, 16, 16)
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-5)
    close_tree(pg, rg, 1e-4)


def test_train_loss_grads_flash_branch_equal_reference():
    """S = 2560 > 2048 takes the flash branch on both sides: the port's
    plain online softmax and its plain backward
    (``flash_attention_backward_plain``) against JAX's autodiff of
    ``flash_attention_xla`` (q chunks of 512, kv chunks of 512)."""
    pl, pg, rl, rg = _model_grads("stablelm-1.6b", 1, 2560, 512, 512)
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-5)
    close_tree(pg, rg, 1e-4)


# ---------------------------------------------------------------------------
# ops under autograd
# ---------------------------------------------------------------------------

def _site_table(cfg, stat):
    ec = pt_engine.shape_exec_config(
        cfg, pt_base.ShapeConfig("t", "train", 32, 2), use_kernels=True,
        device="cpu")
    sites = {s: dataclasses.replace(d, schedule=dataclasses.replace(
        d.schedule, stationarity=stat)) for s, d in ec.schedules.sites.items()}
    return dataclasses.replace(ec, schedules=dataclasses.replace(
        ec.schedules, sites=sites))


@pytest.mark.parametrize("stat", ["output", "weight", "input"])
@pytest.mark.parametrize("kernels", [True, False])
def test_flex_matmul_grads_equal_autograd_of_plain(stat, kernels):
    cfg = pt_base.get_smoke_config("stablelm-1.6b")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(cfg.d_model, cfg.d_ff)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_ff)).astype(
        np.float32))
    ec = _site_table(cfg, stat) if kernels else pt_ops.ExecConfig()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    with pt_ops.exec_config(ec):
        out = pt_ops.flex_matmul(xa, wa, site="mlp.in")
    out.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.matmul(xb, wb).backward(g)
    for a, b in ((out, torch.matmul(x, w)), (xa.grad, xb.grad),
                 (wa.grad, wb.grad)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_no_backward_routes_raise_under_grad():
    cfg = pt_base.get_smoke_config("stablelm-1.6b")
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.randn(64, 32)
    ec = _site_table(cfg, "output")
    two = dataclasses.replace(ec, schedules=dataclasses.replace(
        ec.schedules, sites={s: dataclasses.replace(d, sparsity_mode=(
            "two_sided")) for s, d in ec.schedules.sites.items()}))
    with pt_ops.exec_config(two), pytest.raises(NotImplementedError,
                                                match="mlp.in"):
        pt_ops.flex_matmul(x, w, site="mlp.in")
    q8 = QuantizedLinear(q=torch.zeros((64, 32), dtype=torch.int8),
                         scale=torch.ones(32))
    with pytest.raises(NotImplementedError, match="attn.q"):
        pt_ops.flex_matmul(x, q8, site="attn.q")
    # the expert route: a dense expert weight has a backward (tests/
    # test_torch_train_families.py); a planned one and a two_sided
    # descriptor do not
    xe = torch.randn(2, 3, 64, requires_grad=True)
    pwe = PlannedWeight(w=torch.randn(2, 64, 8),
                        wkidx=torch.zeros(2, 1, 1, dtype=torch.int32),
                        wkcnt=torch.zeros(2, 1, dtype=torch.int32),
                        b_bitmap=torch.ones(2, 1, 1, dtype=torch.bool),
                        site="moe.experts_in")
    with pytest.raises(NotImplementedError, match="moe.experts_in"):
        pt_ops.flex_expert_matmul(xe, pwe, site="moe.experts_in")
    mcfg = pt_base.get_smoke_config("deepseek-moe-16b")
    mec = _site_table(mcfg, "output")
    mtwo = dataclasses.replace(mec, schedules=dataclasses.replace(
        mec.schedules, sites={s: dataclasses.replace(d, sparsity_mode=(
            "two_sided")) for s, d in mec.schedules.sites.items()}))
    with pt_ops.exec_config(mtwo), pytest.raises(NotImplementedError,
                                                 match="moe.experts_gate"):
        pt_ops.flex_expert_matmul(xe, torch.randn(2, 64, 8),
                                  site="moe.experts_gate")
    pw = object.__new__(PlannedWeight)
    with pytest.raises(NotImplementedError, match="lm_head"):
        pt_ops.flex_matmul(x, pw, site="lm_head")
    # without autograd the same calls run
    with torch.no_grad(), pt_ops.exec_config(two):
        assert pt_ops.flex_matmul(x, w, site="mlp.in").shape == (4, 32)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro,grad_dtype", [(1, "f32"), (2, "f32"),
                                                (1, "bf16"), (2, "bf16")])
def test_make_step_fn_equals_reference(n_micro, grad_dtype):
    """One and three steps: params, opt state, loss, grad_norm and lr."""
    cfg, rcfg, rp, pp = setup("stablelm-1.6b")
    shape = dataclasses.replace(SHAPE, n_micro=n_micro,
                                grad_dtype=grad_dtype)
    rstep = jax.jit(ref_step.make_step_fn(rcfg, ref_shape(shape),
                                          ref_opt.AdamWConfig(**OPT)))
    pstep = pt_step.make_step_fn(cfg, shape, pt_opt.AdamWConfig(**OPT))
    rs, ps = ref_opt.init_opt_state(rp), pt_opt.init_opt_state(pp)
    bf16 = grad_dtype == "bf16"
    lr_sum = 0.0
    for i in range(3):
        batch = batch_np(cfg, seed=20 + i)
        rp, rs, rm = rstep(rp, rs, to_ref(batch))
        pp, ps, pm = pstep(pp, ps, to_port(batch))
        np.testing.assert_allclose(pm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(rm["grad_norm"]),
                                   rtol=2.0 ** -7 if bf16 else 1e-4)
        np.testing.assert_allclose(pm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-6)
        lr_sum += pm["lr"].item()
        if i in (0, 2):
            close_params(pp, rp, 1e-4 if bf16 else 1e-5, lr_sum)
            close_tree(ps.mu, rs.mu, 2.0 ** -7 if bf16 else 1e-5)
            close_tree(ps.nu, rs.nu, 2.0 ** -7 if bf16 else 1e-5)
    assert int(ps.step) == 3


@pytest.mark.parametrize("kernels", [False, True])
def test_remat_policies_bit_equal(kernels):
    cfg, _, _, pp = setup("stablelm-1.6b")
    batch = to_port(batch_np(cfg, 2, 32, seed=6))
    ec = _site_table(cfg, "output") if kernels else pt_ops.ExecConfig()
    out = {}
    for remat in ("none", "dots", "full"):
        fn = pt_step.loss_for(cfg, dataclasses.replace(SHAPE, remat=remat))
        with pt_ops.exec_config(ec):
            out[remat] = pt_step.value_and_grad(fn, pp, batch)
    l0, g0 = out["none"]
    for remat in ("dots", "full"):
        l, g = out[remat]
        assert torch.equal(l, l0), remat
        for a, b in zip(pt_opt.tree_leaves(g), pt_opt.tree_leaves(g0)):
            assert torch.equal(a, b), remat


def test_dots_replays_the_recorded_products():
    """Under remat="dots" the backward's recomputation takes the matmul
    outputs back from the tape: no site runs twice."""
    cfg, _, _, pp = setup("stablelm-1.6b")
    batch = to_port(batch_np(cfg, 2, 32, seed=6))
    calls = []
    orig = pt_ops._dense_product

    def spy(*a):
        calls.append(1)
        return orig(*a)
    pt_ops._dense_product = spy
    try:
        counts = {}
        for remat in ("dots", "full"):
            calls.clear()
            fn = pt_step.loss_for(cfg, dataclasses.replace(SHAPE, remat=remat))
            pt_step.value_and_grad(fn, pp, batch)
            counts[remat] = len(calls)
    finally:
        pt_ops._dense_product = orig
    sites = 6 * cfg.n_layers          # q, kv, out, in, gate, out per layer
    assert counts == {"dots": sites, "full": 2 * sites}


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
def test_token_pipeline_batches_bit_equal(tmp_path, shard, n_shards):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(7).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    for source in ("synthetic", "file"):
        kw = dict(vocab=1000, seq_len=24, global_batch=4, seed=9,
                  source=source, path=str(path) if source == "file" else None,
                  shard=shard, n_shards=n_shards)
        rp = ref_pipe.TokenPipeline(ref_pipe.DataConfig(**kw))
        pp = pt_pipe.TokenPipeline(pt_pipe.DataConfig(**kw))
        for _ in range(3):
            a, b = rp.next_batch(), pp.next_batch()
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        snap = pp.snapshot()
        pp.next_batch()
        pp.restore(snap)
        rp.restore(snap)
        assert np.array_equal(rp.next_batch()["tokens"],
                              pp.next_batch()["tokens"])


@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_with_frontend_inputs_bit_equal(frontend):
    rcfg = ref_config(pt_base.get_smoke_config("whisper-tiny"))
    if frontend == "vision":
        rcfg = dataclasses.replace(rcfg, encoder_decoder=False,
                                   frontend="vision")
    batch = batch_np(rcfg, 2, 32, seed=8)
    n = ref_model.n_vis(rcfg, 32)
    a = ref_pipe.with_frontend_inputs(batch, rcfg, n_vis=n)
    b = pt_pipe.with_frontend_inputs(batch, rcfg, n_vis=pt_model.n_vis(
        rcfg, 32))
    assert sorted(a) == sorted(b)
    assert len(a) == (3 if frontend == "audio" else 4)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------

def test_trainer_checkpoint_resume(tmp_path):
    """The reference's resume test (tests/test_train.py): a fresh trainer
    resumes from the step-6 checkpoint, and a straight run over the same
    data ends on the same loss — here bit for bit."""
    cfg = pt_base.get_smoke_config("stablelm-1.6b")
    opt = pt_opt.AdamWConfig(**OPT)
    pipe_cfg = pt_pipe.DataConfig(vocab=cfg.vocab, seq_len=SHAPE.seq_len,
                                  global_batch=SHAPE.global_batch, seed=7)

    def trainer(steps, ckpt_dir):
        tc = TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=3,
                           log_every=100)
        return Trainer(cfg, SHAPE, opt, tc,
                       pipeline=pt_pipe.TokenPipeline(pipe_cfg),
                       device="cpu")

    log1 = trainer(6, str(tmp_path)).run()
    assert len(log1) == 6
    t2 = trainer(9, str(tmp_path))
    log2 = t2.run()
    assert [r["step"] for r in log2] == [7, 8, 9]
    t3 = trainer(9, None)
    log3 = t3.run()
    assert log3[-1]["loss"] == log2[-1]["loss"]
    for a, b in zip(pt_opt.tree_leaves(t2.params),
                    pt_opt.tree_leaves(t3.params)):
        assert torch.equal(a, b)


def test_watchdog_detects_straggler():
    wd = Watchdog(WatchdogConfig(factor=3.0, min_history=3))
    for i in range(5):
        assert not wd.observe(i, 1.0)
    assert wd.observe(5, 10.0)            # 10× median breaches 3× deadline
    assert wd.events and wd.events[0]["step"] == 5
    assert not wd.observe(6, 1.1)         # normal step after


def test_watchdog_warmup_no_false_positives():
    wd = Watchdog(WatchdogConfig(factor=2.0, min_history=5))
    assert not wd.observe(0, 100.0)       # no deadline yet
    assert wd.deadline() is None


def test_launcher_smoke_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    log = launch.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert "done: 3 steps" in capsys.readouterr().out
    # one process holds no 2 model shards (torchrun starts the ranks that
    # do: tests/test_torch_dist_train.py)
    with pytest.raises(ValueError, match="model shards"):
        launch.make_trainer(launch.parse_args(
            ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
             "--model-shards", "2"]))


def test_state_crosses_both_ways():
    """Params and opt state: reference → port → numpy equals the
    reference's (bf16 leaves exactly too)."""
    cfg, rcfg, rp, _ = setup("stablelm-1.6b")
    rb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), rp)
    pb = params_from_numpy(jax.tree.map(np.asarray, rb), device="cpu")
    back = params_to_numpy(pb)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(rb)[0]:
        node = back
        for k in kp:
            node = node[k.key]
        assert np.array_equal(np.asarray(leaf.astype(jnp.float32)), node)
    rs = ref_opt.init_opt_state(rp)
    rs = rs._replace(step=jnp.asarray(5, jnp.int32),
                     mu=jax.tree.map(lambda x: x * 0.5, rp))
    ps = opt_state_from_numpy(jax.tree.map(np.asarray, rs), device="cpu")
    step, mu, _ = opt_state_to_numpy(ps)
    assert int(step) == 5 and ps.step.dtype == torch.int32
    close_tree(ps.mu, rs.mu, 0.0, 0.0)
