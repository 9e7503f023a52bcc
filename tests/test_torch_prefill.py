"""The port's full-sequence prefill against the JAX package's: the flash
attention plain versions, ``attention_forward`` (dense and flash
branches), ``model.prefill`` (dense and planned two-sided weights, bf16
float and int8), ``prefill_with_cache`` and the greedy decode that
continues from its state, on numpy-seeded smoke inputs.

Tolerances:
- float32: both sides compute the same function in float32 and differ only
  in the order of summation, so they agree to ~1e-6; the bar is rtol =
  atol = 1e-5 for a single attention and 1e-4 for logits (as in
  ``test_torch_serve.py``).  Plan metadata is integer-exact.
- bf16 flash kernel order: both sides sum exact bf16 products in float32,
  so they differ by one bf16 ulp of the output where it lands next to a
  rounding boundary: rtol = atol = 2⁻⁷ admits one ulp at any magnitude.
- bf16 dense oracle / ``attention_forward``: the reference rounds the
  scores to bf16 before the softmax; a score whose float32 sum differs in
  its last bits may round to the neighbouring bf16 value, which moves its
  weight by up to one bf16 ulp of the score (2⁻⁸·|s|, |s| ≲ 4): rtol =
  atol = 2⁻⁵.
Greedy streams are compared token for token on pinned seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import descriptors as ref_desc
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.quant import quantize as ref_q
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels.ref import flash_attention_plain, flash_attention_ref
from repro_torch.models import attention as pt_attn
from repro_torch.models import model as pt_model
from repro_torch.quant.quantize import quantize_params
from repro_torch.serve import engine as pt_engine

ARCHS = ["edge-tiny", "stablelm-1.6b", "yi-9b", "gemma-2b",
         "chatglm3-6b"]
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_KERNEL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
BF16_ORACLE = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def _np(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


_CACHE = {}


def setup(arch, planned=False, dtype="f32"):
    """(port cfg, ref cfg, ref params, port params) from the reference's
    init; planned setups prune with the reference's pruner."""
    key = (arch, planned, dtype)
    if key not in _CACHE:
        cfg = pt_base.get_smoke_config(arch)
        if planned:
            cfg = dataclasses.replace(cfg, sparsity=SPARSE)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0),
                                   dtype=DTYPES[dtype][1])
        if planned:
            rp = jax.tree.map(
                lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5,
                                                            (16, 16)), rp)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _CACHE[key] = (cfg, rcfg, rp, pp)
    return _CACHE[key]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _prefill_shape(b, s):
    return pt_base.ShapeConfig("prefill", "prefill", s, b)


def _ref_shape_exec(rcfg, shape, rp, quantize=False):
    """The reference's ``decode_exec_config`` recipe at another shape: the
    table under priors, measured densities, the table again, the plan."""
    ns = ref_desc.compile_network_schedule(rcfg, shape, quantize=quantize)
    if quantize:
        rp, _ = ref_q.quantize_params(rp, tie_embeddings=rcfg.tie_embeddings)
    measured = ref_sp.measure_weight_densities(rp, ns)
    ns = ref_desc.compile_network_schedule(rcfg, shape, wt_densities=measured,
                                           quantize=quantize)
    plan = ref_sp.compile_weight_plan(rp, ns,
                                      ref_elem_bytes=2 if quantize else None)
    return ref_ops.ExecConfig(schedules=ns, plan=plan, quantize=quantize)


# ---------------------------------------------------------------------------
# the flash-attention plain versions against the Pallas kernel and its oracle
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (bh, sq, skv, hd, causal, window, block)
    (4, 256, 256, 64, True, 0, 64),
    (4, 256, 256, 64, False, 0, 128),
    (8, 512, 512, 128, True, 0, 128),
    (2, 128, 128, 32, False, 0, 64),
    (4, 512, 512, 64, True, 64, 64),
    (4, 512, 512, 64, True, 128, 128),
    (4, 128, 512, 64, True, 0, 64),
    (4, 128, 512, 64, True, 0, 128),
    # head dim 256 (gemma-2b, recurrentgemma-9b): causal, windowed, full
    (2, 128, 128, 256, True, 0, 64),
    (2, 128, 128, 256, True, 64, 64),
    (2, 128, 128, 256, False, 0, 64),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=[
    f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{'causal' if c[4] else 'full'}-w{c[5]}"
    f"-b{c[6]}" for c in FLASH_CASES])
def test_flash_plain_versions_match_reference(case, dtype):
    bh, sq, skv, hd, causal, window, block = case
    rng = np.random.default_rng(sum(case))
    q = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(bh, skv, hd)).astype(np.float32)
            for _ in range(2))
    tdt, jdt = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    pallas = ref_flash(jq, jk, jv, causal=causal, window=window, bq=block,
                       bkv=block, interpret=True)
    plain = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                  bq=block, bkv=block)
    assert plain.dtype == tdt
    np.testing.assert_allclose(_np(plain), _np(pallas),
                               **(F32 if dtype == "f32" else BF16_KERNEL))
    oracle = ref_kref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window)
    ours = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(ours), _np(oracle),
                               **(F32 if dtype == "f32" else BF16_ORACLE))


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 128, 64))
    narrow, wide = torch.zeros((2, 128, 8)), torch.zeros((2, 128, 512))
    with pytest.raises(ValueError, match="head dim"):
        pt_fa.flash_attention(narrow, narrow, narrow)
    with pytest.raises(ValueError, match="head dim"):
        pt_fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="multiples of 64"):
        pt_fa.flash_attention(torch.zeros((2, 96, 64)), x, x)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        pt_fa.flash_attention(torch.zeros((2, 256, 64)), x, x)
    with pytest.raises(TypeError, match="differ in type"):
        pt_fa.flash_attention(x.bfloat16(), x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pt_fa.flash_attention(x.double(), x.double(), x.double())
    before = dict(pt_fa.LAUNCHES)
    out = pt_fa.flash_attention(x, x, x)     # CPU: the plain version
    assert out.shape == x.shape and pt_fa.LAUNCHES == before


# ---------------------------------------------------------------------------
# attention_forward: dense and flash branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,use_flash", [(64, False), (64, True),
                                         (2560, None)],
                         ids=["dense-64", "flash-64", "dispatch-2560"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_forward_matches_reference(arch, s, use_flash, dtype):
    cfg, rcfg, rp, pp = setup(arch, dtype=dtype)
    b = 2 if s <= 64 else 1
    x = np.random.default_rng(s).normal(size=(b, s, cfg.d_model)) \
        .astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    positions = np.broadcast_to(np.arange(s)[None], (b, s))
    rlayer = jax.tree.map(lambda leaf: leaf[0], rp["stack"]["layers"]["attn"])
    out_r, (kr, vr) = ref_attn.attention_forward(
        rlayer, rcfg, jnp.asarray(x).astype(jdt),
        positions=jnp.asarray(positions), use_flash=use_flash,
        return_kv=True)
    player = {n: w[0] for n, w in pp["stack"]["layers"]["attn"].items()}
    out_p, (kp, vp) = pt_attn.attention_forward(
        player, cfg, torch.from_numpy(x).to(tdt),
        positions=torch.from_numpy(positions.copy()), use_flash=use_flash,
        return_kv=True)
    tol = F32 if dtype == "f32" else BF16_ORACLE
    assert out_p.dtype == tdt
    np.testing.assert_allclose(_np(out_p), _np(out_r), **tol)
    np.testing.assert_allclose(_np(kp), _np(kr), **tol)
    np.testing.assert_allclose(_np(vp), _np(vr), **tol)


# ---------------------------------------------------------------------------
# model.prefill: dense and planned weights, float and int8
# ---------------------------------------------------------------------------

def _both_prefill(rcfg, rparams, rec, cfg, pparams, pec, toks):
    with ref_ops.exec_config(rec or ref_ops.ExecConfig()):
        rlog = jax.jit(lambda p, t: ref_model.prefill(
            p, rcfg, {"tokens": t}))(rparams, toks)
    with pt_ops.exec_config(pec or pt_ops.ExecConfig()):
        plog = pt_model.prefill(pparams, cfg,
                                {"tokens": torch.from_numpy(toks).long()})
    return plog, rlog


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
@pytest.mark.parametrize("s", [64, 2560])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, s, planned):
    cfg, rcfg, rp, pp = setup(arch, planned)
    b = 2 if s <= 64 else 1
    toks = _tokens(cfg, b, s, seed=s)
    rec = pec = None
    rparams, pparams = rp, pp
    if planned:
        shape = _prefill_shape(b, s)
        rec = _ref_shape_exec(rcfg, shape, rp)
        pec = pt_engine.shape_exec_config(cfg, shape, params=pp,
                                          device="cpu")
        ours, theirs = pec.plan, rec.plan
        assert sorted(ours.entries) == sorted(theirs.entries)
        for key, e in ours.entries.items():
            r = theirs.entries[key]
            assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn,
                    e.max_nnz) == (r.site, r.mode, r.bm, r.bk, r.bn, r.tk,
                                   r.tn, r.max_nnz), key
            np.testing.assert_array_equal(e.wkidx, r.wkidx)
            np.testing.assert_array_equal(e.wkcnt, r.wkcnt)
        for site, d in pec.schedules.sites.items():
            assert d.describe() == rec.schedules.sites[site].describe()
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    plog, rlog = _both_prefill(rcfg, rparams, rec, cfg, pparams, pec, toks)
    assert plog.shape == (b, 1, cfg.vocab) and plog.dtype == torch.float32
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **LOGITS)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_prefill_matches_reference(arch, planned):
    cfg, rcfg, rp, pp = setup(arch, planned)
    b, s = 2, 64
    toks = _tokens(cfg, b, s, seed=7)
    rq, _ = ref_q.quantize_params(rp, tie_embeddings=rcfg.tie_embeddings)
    pq, _ = quantize_params(pp, tie_embeddings=cfg.tie_embeddings)
    rec, pec = ref_ops.ExecConfig(quantize=True), pt_ops.ExecConfig(
        quantize=True)
    if planned:
        shape = _prefill_shape(b, s)
        rec = _ref_shape_exec(rcfg, shape, rp, quantize=True)
        pec = pt_engine.shape_exec_config(cfg, shape, params=pp,
                                          quantize=True, device="cpu")
        # a tied head is never planned
        assert ("lm_head" in pec.plan.entries) == (not cfg.tie_embeddings)
        assert all(e.quantized for e in pec.plan.entries.values())
        rq, pq = rec.plan.attach(rq), pec.plan.attach(pq)
    plog, rlog = _both_prefill(rcfg, rq, rec, cfg, pq, pec, toks)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **LOGITS)


# ---------------------------------------------------------------------------
# prefill_with_cache, and the decode that continues from it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("edge-tiny", 40), ("stablelm-1.6b", 40),
                                    ("stablelm-1.6b", 2560)])
def test_prefill_with_cache_matches_reference_and_continues(arch, s):
    cfg, rcfg, rp, pp = setup(arch)
    b, max_seq, n_steps = 2, s + 24, 8
    toks = _tokens(cfg, b, s, seed=s + 1)
    rlog, rstate = jax.jit(lambda p, t: ref_model.prefill_with_cache(
        p, rcfg, {"tokens": t}, max_seq, dtype=jnp.float32))(rp, toks)
    plog, pstate = pt_model.prefill_with_cache(
        pp, cfg, {"tokens": torch.from_numpy(toks).long()}, max_seq,
        dtype=torch.float32)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **LOGITS)
    for name in ("k", "v"):
        assert pstate["layers"][name].shape == \
            rstate["layers"][name].shape
        np.testing.assert_allclose(pstate["layers"][name].numpy(),
                                   np.asarray(rstate["layers"][name]),
                                   **LOGITS)
    # the prefill's own logits equal prefill()'s
    same = pt_model.prefill(pp, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(same, plog)
    # greedy decode continues from position S on both sides
    first = np.asarray(np.argmax(np.asarray(rlog)[:, 0], -1), np.int32)
    assert np.array_equal(first, plog[:, 0].argmax(-1).numpy())
    pos = np.full((b,), s, np.int32)
    live = np.ones((b,), bool)
    rtoks = jax.jit(lambda p, t, st, q, lv: ref_model.decode_many(
        p, rcfg, t, st, q, lv, n_steps)[0])(rp, first, rstate, pos, live)
    ptoks = pt_model.decode_many(pp, cfg, torch.from_numpy(first), pstate,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(live), n_steps)[0]
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(rtoks))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_cache_equals_token_by_token_prefill(arch):
    """The port's two ways of filling a slot agree: the full-sequence pass
    and one masked decode step per prompt token (atol = rtol = 1e-4 in
    float32, as the decode path is held in ``test_torch_serve.py``)."""
    cfg, _, _, pp = setup(arch)
    s, max_seq = 24, 32
    toks = _tokens(cfg, 1, s, seed=3)
    _, full = pt_model.prefill_with_cache(
        pp, cfg, {"tokens": torch.from_numpy(toks).long()}, max_seq,
        dtype=torch.float32)
    state = pt_model.init_decode_state(cfg, 1, max_seq, dtype=torch.float32,
                                       device="cpu")
    state = pt_model.prefill_into_slot(pp, cfg, toks[0], np.ones(s, bool), 0,
                                       state, torch.zeros(1, dtype=torch.long))
    for name in ("k", "v"):
        np.testing.assert_allclose(full["layers"][name].numpy(),
                                   state["layers"][name].numpy(), **LOGITS)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_prefill_refuses_tokens_off_the_params_device():
    cfg, _, _, pp = setup("edge-tiny")
    meta = torch.zeros((1, 8), dtype=torch.long, device="meta")
    for fn in (lambda t: pt_model.prefill(pp, cfg, {"tokens": t}),
               lambda t: pt_model.prefill_with_cache(pp, cfg, {"tokens": t},
                                                     16)):
        with pytest.raises(ValueError, match="params on cpu"):
            fn(meta)
        with pytest.raises(TypeError, match="torch tensor"):
            fn(np.zeros((1, 8), np.int32))
    on_meta = {**pp, "embed": pp["embed"].to("meta")}
    cpu_tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="params on meta"):
        pt_model.prefill(on_meta, cfg, {"tokens": cpu_tokens})
    with pytest.raises(NotImplementedError, match="token input"):
        pt_model.prefill(pp, cfg, {"tokens": meta, "frames": meta})


def test_prefill_with_kernels_on_cpu_runs_the_plain_versions():
    """``use_kernels`` on CPU tensors: every wrapper (the flex matmul and
    the flash kernel's) runs its plain version, and no launch is counted.
    The flash wrapper takes head dims 32, 64, 128 and 256, so the smoke model
    gets 2 heads of 32; S = 2560 takes the flash branch."""
    cfg = dataclasses.replace(pt_base.get_smoke_config("stablelm-1.6b"),
                              n_heads=2, n_kv_heads=2, head_dim=32)
    pp = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 2560, seed=9)).long()
    ec = pt_engine.shape_exec_config(cfg, _prefill_shape(1, 2560),
                                     use_kernels=True, device="cpu")
    before = dict(pt_fa.LAUNCHES)
    with pt_ops.exec_config(ec):
        with_kernels = pt_model.prefill(pp, cfg, {"tokens": toks})
    plain = pt_model.prefill(pp, cfg, {"tokens": toks})
    assert pt_fa.LAUNCHES == before
    np.testing.assert_allclose(with_kernels.numpy(), plain.numpy(), **LOGITS)
