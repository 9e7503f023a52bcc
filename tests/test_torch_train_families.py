"""Training of the families beyond the dense decoder, in the port against
the JAX package: ``train_loss`` and every leaf's gradient for the MoE
(with and without dropped tokens), SSM, Griffin (past its window),
Whisper (with ``frames``) and MQA (Gemma, at head dim 256 under the
kernel routes) smoke configs, the MoE train step at two microbatches,
``load_balance_loss``, the expert route's autograd Function, remat and
the launcher — smoke sizes, float32, numpy seeds; the reference runs as
its own tests run it (plain jnp paths under ``jax.value_and_grad``).

Tolerances are those of ``tests/test_torch_train.py``: loss rtol 1e-5,
each leaf's gradient within 1e-4·max|ref| + 1e-7 (the backward sums over
every row of the batch and through every layer, each side in its own
order); the step's parameters and moments as there.  The expert
Function's CPU gradients and the remat variants are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipe
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import moe as pt_moe
from repro_torch.train import optimizer as pt_opt
from repro_torch.train import train_step as pt_step
from test_torch_train import (OPT, SHAPE, _site_table, batch_np, close_params,
                              close_tree, ref_config, ref_shape, to_port,
                              to_ref)

MOE = "deepseek-moe-16b"


def moe_cfg(capacity_factor):
    cfg = pt_base.get_smoke_config(MOE)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


# capacity factors: 1.0 drops routed (token, slot) pairs at B 2, S 32 on
# these weights (checked below), 8.0 gives every pair a slot
DROPS, NO_DROPS = 1.0, 8.0


def _params(cfg):
    rcfg = ref_config(cfg)
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    return rcfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp),
                                       device="cpu")


def _batch(cfg, rcfg, b, s, seed=4):
    batch = batch_np(cfg, b, s, seed=seed)
    if cfg.encoder_decoder:
        batch = ref_pipe.with_frontend_inputs(batch, rcfg)
    return batch


def _grads(cfg, b, s, chunk=16, attn_chunk=16, remat="none", ec=None):
    rcfg, rp, pp = _params(cfg)
    batch = _batch(cfg, rcfg, b, s)
    rl, rg = jax.value_and_grad(
        lambda p: ref_model.train_loss(p, rcfg, to_ref(batch), remat=remat,
                                       loss_chunk=chunk, q_chunk=attn_chunk)
    )(rp)
    fn = pt_step.loss_for(cfg, dataclasses.replace(
        SHAPE, seq_len=s, global_batch=b, loss_chunk=chunk,
        attn_chunk=attn_chunk, remat=remat))
    with pt_ops.exec_config(ec or pt_ops.ExecConfig()):
        pl, pg = pt_step.value_and_grad(fn, pp, to_port(batch))
    return pl, pg, rl, rg


def _gemma_hd256():
    return dataclasses.replace(pt_base.get_smoke_config("gemma-2b"),
                               head_dim=256)


# (label, config, batch, seq, loss / attention chunks, ExecConfig)
CASES = {
    "moe-drops": (lambda: moe_cfg(DROPS), 2, 32, 16, None),
    "moe-no-drops": (lambda: moe_cfg(NO_DROPS), 2, 32, 16, None),
    "mamba2": (lambda: pt_base.get_smoke_config("mamba2-1.3b"), 2, 32, 16,
               None),
    # S 64 is past the smoke window of 32: the windowed branch
    "griffin-past-window": (
        lambda: pt_base.get_smoke_config("recurrentgemma-9b"), 1, 64, 16,
        None),
    "whisper-frames": (lambda: pt_base.get_smoke_config("whisper-tiny"), 2,
                       32, 16, None),
    # MQA (one kv head) at hd 256 under the kernel routes (their plain
    # versions on the CPU)
    "gemma-hd256": (_gemma_hd256, 2, 64, 16,
                    pt_ops.ExecConfig(use_kernels=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_equal_reference(case):
    make, b, s, chunk, ec = CASES[case]
    cfg = make()
    pl, pg, rl, rg = _grads(cfg, b, s, chunk=chunk, attn_chunk=chunk, ec=ec)
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-5)
    close_tree(pg, rg, 1e-4)


@pytest.mark.parametrize("cf,drops", [(DROPS, True), (NO_DROPS, False)])
def test_moe_capacity_cases_drop_as_named(cf, drops):
    """The two capacity factors above do what their names say on the
    gradient tests' batch: layer 1's router (the MoE layer's) at 1.0
    leaves some (token, slot) pairs without a slot, at 8.0 none."""
    cfg = moe_cfg(cf)
    _, _, pp = _params(cfg)
    batch = to_port(batch_np(cfg, 2, 32, seed=4))
    x = pp["embed"][batch["tokens"]].reshape(-1, cfg.d_model)
    _, idx = pt_moe._route(pp["stack"]["layers"]["moe"]["router"][0], x,
                           cfg.moe.top_k)
    t = x.shape[0]
    cap = pt_moe._capacity(t, cfg.moe.top_k, cfg.moe.n_experts, cf)
    _, valid = pt_moe._dispatch_indices(idx.reshape(-1), cfg.moe.n_experts,
                                        cap)
    assert (int(valid.sum()) < t * cfg.moe.top_k) == drops


def test_moe_step_fn_equals_reference():
    """Two steps of ``make_step_fn`` at n_micro 2: params, moments, loss,
    grad_norm and lr."""
    cfg = moe_cfg(DROPS)
    rcfg, rp, pp = _params(cfg)
    shape = dataclasses.replace(SHAPE, n_micro=2)
    rstep = jax.jit(ref_step.make_step_fn(rcfg, ref_shape(shape),
                                          ref_opt.AdamWConfig(**OPT)))
    pstep = pt_step.make_step_fn(cfg, shape, pt_opt.AdamWConfig(**OPT))
    rs, ps = ref_opt.init_opt_state(rp), pt_opt.init_opt_state(pp)
    lr_sum = 0.0
    for i in range(2):
        batch = batch_np(cfg, seed=30 + i)
        rp, rs, rm = rstep(rp, rs, to_ref(batch))
        pp, ps, pm = pstep(pp, ps, to_port(batch))
        np.testing.assert_allclose(pm["loss"].item(), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(pm["lr"].item(), float(rm["lr"]),
                                   rtol=1e-6)
        lr_sum += pm["lr"].item()
    close_params(pp, rp, 1e-5, lr_sum)
    close_tree(ps.mu, rs.mu, 1e-5)
    close_tree(ps.nu, rs.nu, 1e-5)
    assert int(ps.step) == 2


@pytest.mark.parametrize("t,e,cf", [(64, 8, 1.25), (48, 4, 2.0)])
def test_load_balance_loss_equals_reference(t, e, cf):
    """On the reference's own one-hot dispatch (``_top_k_gating``), value
    (rtol 1e-6) and gradient with respect to the logits, within 1e-5 of
    its largest element: each element is p·(f − Σ f·p), a difference of
    sums over E that cancel to a few % of their terms, so float32's
    last-bit differences show at ~1e-6 of the largest."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    k = 2
    cap = ref_moe._capacity(t, k, e, cf)
    dispatch, _ = ref_moe._top_k_gating(jnp.asarray(logits), k, cap)
    rl, rg = jax.value_and_grad(ref_moe.load_balance_loss)(
        jnp.asarray(logits), dispatch)
    pl_in = torch.from_numpy(logits).requires_grad_()
    pl = pt_moe.load_balance_loss(pl_in,
                                  torch.from_numpy(np.array(dispatch)))
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)
    np.testing.assert_allclose(pl_in.grad.numpy(), np.asarray(rg), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(rg)).max())


@pytest.mark.parametrize("c", [3, 40])
@pytest.mark.parametrize("kernels", [False, True])
def test_expert_grads_bit_equal_autograd_of_plain(kernels, c):
    """The expert route's Function: forward, dX and dW on the CPU equal
    autograd of the plain batched float32 product bit for bit, at a decode
    capacity (C ≤ 16) and above it, through the plain product and
    through the kernel route's CPU version (``flex_matmul`` over E, Wᵀ as
    the transposed view of the stacked weight)."""
    rng = np.random.default_rng(11)
    e, k, n = 4, 64, 48
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(e, c, n)).astype(np.float32))
    ec = (_site_table(moe_cfg(DROPS), "output") if kernels
          else pt_ops.ExecConfig())
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    with pt_ops.exec_config(ec):
        out = pt_ops.flex_expert_matmul(xa, wa, site="moe.experts_in")
    out.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = torch.matmul(xb, wb)
    ref.backward(g)
    for a, b in ((out, ref), (xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert torch.equal(a, b)


def test_expert_grads_promote_mixed_dtypes():
    """Operands of two dtypes meet in the promoted one, as without grad,
    and each gradient comes back in its operand's dtype."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 32, 16)).astype(
        np.float32)).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = pt_ops.flex_expert_matmul(xa, wa, site="moe.experts_in")
    with torch.no_grad():
        want = pt_ops.flex_expert_matmul(x, w, site="moe.experts_in")
    assert out.dtype == torch.float32 and torch.equal(out, want)
    out.sum().backward()
    assert xa.grad.dtype == torch.float32 and wa.grad.dtype == torch.bfloat16
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.matmul(xb, wb.float()).sum().backward()
    assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad)


def test_dense_attention_promotes_mixed_dtypes():
    """A bf16 decoder's queries on a float32 encoder memory (Whisper
    trained with bf16 weights on the pipeline's float32 frames): the
    scores and the weighted sum run in float32, as ``jnp.einsum``
    promotes, and the weights round to the queries' bf16 on both sides —
    within one bf16 rounding of a weight (2⁻⁸ of Σ|w·v|)."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as pt_attn
    rng = np.random.default_rng(13)
    q = rng.normal(size=(2, 8, 2, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(ref_attn.dense_attention(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
        None))
    got = pt_attn.dense_attention(torch.from_numpy(q).bfloat16(),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  None)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(v).max())


def _griffin_wide():
    """recurrentgemma-9b's smoke config with hd 64, which the flash
    kernel's wrapper takes (the smoke hd 16 it refuses)."""
    return dataclasses.replace(
        pt_base.get_smoke_config("recurrentgemma-9b"), head_dim=64)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", [MOE, "recurrentgemma-9b"])
def test_remat_policies_bit_equal(arch, kernels):
    """remat none / dots / full give the same loss and gradients bit for
    bit (the MoE layer's expert Function and the Griffin group's RG-LRU
    scan and windowed attention; S 64 is past the smoke window)."""
    if arch == MOE:
        cfg = moe_cfg(DROPS)
    else:
        cfg = _griffin_wide() if kernels else pt_base.get_smoke_config(arch)
    _, _, pp = _params(cfg)
    batch = to_port(batch_np(cfg, 1, 64, seed=6))
    ec = _site_table(cfg, "output") if kernels else pt_ops.ExecConfig()
    out = {}
    for remat in ("none", "dots", "full"):
        fn = pt_step.loss_for(cfg, dataclasses.replace(
            SHAPE, seq_len=64, global_batch=1, remat=remat))
        with pt_ops.exec_config(ec):
            out[remat] = pt_step.value_and_grad(fn, pp, batch)
    l0, g0 = out["none"]
    for remat in ("dots", "full"):
        l, g = out[remat]
        assert torch.equal(l, l0), remat
        for a, b in zip(pt_opt.tree_leaves(g), pt_opt.tree_leaves(g0)):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("arch", [MOE, "mamba2-1.3b", "recurrentgemma-9b",
                                  "whisper-tiny", "gemma-2b"])
def test_launcher_trains_every_family_on_cpu(tmp_path, capsys, arch):
    from repro_torch.launch import train as launch
    log = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in log)
    assert "done: 3 steps" in capsys.readouterr().out
