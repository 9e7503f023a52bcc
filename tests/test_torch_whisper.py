"""The port's encoder-decoder family (whisper-tiny: an encoder over
precomputed frame embeddings plus sinusoidal positions, a decoder with
causal self-attention, cross-attention and a plain-GELU MLP, LayerNorm)
against the JAX package's, on the smoke config (2 + 2 layers, d 64, 4
heads of 16) with the reference's weights converted; and the repair of
``PlannedWeight``'s dense route (``x @ planned``), which the decoder's
cross-attention takes at decode.

Tolerances:
- float32: the two sides sum the same products in orders that may differ:
  rtol = atol = 1e-5 for a block or the encoder, 1e-4 for logits,
  hidden states and the decode state (as ``test_torch_serve.py``).
- bf16 attention: the reference rounds the scores to bf16 before the
  softmax, so a score whose float32 sum differs in its last bits moves
  its weight by a bf16 ulp of the score: rtol = atol = 2⁻⁵, as
  ``test_torch_prefill.py`` holds the dense oracle.
- sinusoidal positions: the float32 power 10000^(2i/D) may differ in its
  last bit, so an angle moves by up to two float32 ulps of itself, below
  1500·2⁻²² at 1500 positions: atol = 3.6e-4.
Greedy streams and plan metadata are compared exactly.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import descriptors as ref_desc
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import rope as ref_rope
from repro.models import transformer as ref_tf
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core import sparsity as pt_sp
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import attention as pt_attn
from repro_torch.models import model as pt_model
from repro_torch.models import rope as pt_rope
from repro_torch.models import transformer as pt_tf
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine

ARCH = "whisper-tiny"
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_ATTN = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
N_SLOTS, MAX_SEQ = 4, 64
N_FRAMES = 40


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


_CACHE = {}


def setup(planned=False, dtype="f32"):
    """(port cfg, ref cfg, ref params, port params); planned setups prune
    the weights with the reference's pruner."""
    key = (planned, dtype)
    if key not in _CACHE:
        cfg = pt_base.get_smoke_config(ARCH)
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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _prompts(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 20)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _layer(tree, i=0):
    return jax.tree.map(lambda leaf: leaf[i], tree)


def _plans(planned, quantize=False, dtype="f32"):
    """The reference's and the port's decode exec configs."""
    cfg, rcfg, rp, pp = setup(planned, dtype)
    if not planned:
        return None, None
    return (ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                          quantize=quantize),
            pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                         quantize=quantize, device="cpu"))


# ---------------------------------------------------------------------------
# PlannedWeight's dense route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_raw_product_with_a_planned_leaf_matches_reference(quantize):
    """``x @ planned`` is the dense product with ``w_kn`` (the dequantized
    float32 weight of an int8 plan), in the promoted dtype, on both sides:
    decoder layer 0's self-attention ``wq`` and cross-attention ``wq``
    under the plan (bf16 weights)."""
    cfg, rcfg, rp, pp = setup(True, dtype="bf16")
    rec, pec = _plans(True, quantize, dtype="bf16")
    rparams = rec.plan.attach(
        ref_q.quantize_params(rp)[0] if quantize else rp)
    pparams = pec.plan.attach(
        pt_q.quantize_params(pp)[0] if quantize else pp)
    x = _normal((3, cfg.d_model), 1)
    for block in ("attn", "xattn"):
        rw = _layer(rparams["stack"]["decoder"][block]["wq"])
        pw = pt_tf.index_tree(pparams["stack"]["decoder"][block]["wq"], 0)
        assert isinstance(pw, pt_sp.PlannedWeight), block
        assert pw.quantized == quantize
        want = jnp.asarray(x).astype(jnp.bfloat16) @ rw
        got = torch.from_numpy(x).to(torch.bfloat16) @ pw
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert got.dtype == (torch.float32 if quantize else torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want),
                                   **(LOGITS if quantize else BF16_ATTN))


# ---------------------------------------------------------------------------
# config, tree, positions, attention
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    for get in ("CONFIG", "smoke_config"):
        ours = getattr(importlib.import_module(
            "repro_torch.configs.whisper_tiny"), get)
        theirs = getattr(importlib.import_module(
            "repro.configs.whisper_tiny"), get)
        ours = ours() if callable(ours) else ours
        theirs = theirs() if callable(theirs) else theirs
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
    assert ARCH in pt_base.ARCH_IDS
    assert pt_base.get_config(ARCH).encoder_decoder


def test_tree_and_state_match_reference():
    cfg, rcfg, _, _ = setup()
    mine = _flat(pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                      dtype=torch.bfloat16, device="cpu"))
    theirs = _flat(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in mine.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.items()}
    st = _flat(pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                          device="cpu"))
    rst = _flat(ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in st.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in rst.items()}


@pytest.mark.parametrize("s,d", [(64, 64), (448, 384), (1500, 384)])
def test_sinusoidal_positions_match_reference(s, d):
    np.testing.assert_allclose(pt_rope.sinusoidal_positions(s, d).numpy(),
                               np.asarray(ref_rope.sinusoidal_positions(s, d)),
                               rtol=0, atol=3.6e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_cross_attention_forward_matches_reference(use_flash, dtype):
    """Cross-attention: 64 queries over a 128-position memory, no rotary,
    unmasked; the dense branch and the flash branch (its plain route on
    the CPU: the online softmax in (64, 128) blocks)."""
    cfg, rcfg, _, _ = setup()
    tdt, jdt = DTYPES[dtype]
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(1), dtype=jdt)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x, mem = _normal((2, 64, cfg.d_model), 2), _normal((2, 128, cfg.d_model),
                                                       3)
    positions = np.broadcast_to(np.arange(64)[None], (2, 64))
    rl = _layer(rp["stack"]["decoder"]["xattn"])
    pl = pt_tf.index_tree(pp["stack"]["decoder"]["xattn"], 0)
    want = ref_attn.attention_forward(
        rl, rcfg, jnp.asarray(x).astype(jdt),
        positions=jnp.asarray(positions), causal=False,
        kv_x=jnp.asarray(mem).astype(jdt), use_flash=use_flash, q_chunk=64)
    got = pt_attn.attention_forward(
        pl, cfg, torch.from_numpy(x).to(tdt),
        positions=torch.from_numpy(positions.copy()), causal=False,
        kv_x=torch.from_numpy(mem).to(tdt), use_flash=use_flash, q_chunk=64)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_ATTN))


# ---------------------------------------------------------------------------
# the model: encoder, forward, prefill, decode
# ---------------------------------------------------------------------------

def _frames(cfg, b=2, seed=4):
    return _normal((b, N_FRAMES, cfg.d_model), seed)


def _forward_pair(planned, fn, s=24):
    """(reference, port) results of ``fn`` (model.forward_hidden or
    model.prefill) on tokens (2, s) and frames (2, 40), under the decoder
    prefill table and plan (planned) or none."""
    cfg, rcfg, rp, pp = setup(planned)
    b = 2
    toks, frames = _tokens(cfg, b, s, seed=s), _frames(cfg)
    rec, pec = ref_ops.ExecConfig(), pt_ops.ExecConfig()
    rparams, pparams = rp, pp
    if planned:
        shape = pt_base.ShapeConfig("prefill", "prefill", s, b)
        ns = ref_desc.compile_network_schedule(rcfg, shape)
        measured = ref_sp.measure_weight_densities(rp, ns)
        ns = ref_desc.compile_network_schedule(rcfg, shape,
                                               wt_densities=measured)
        rec = ref_ops.ExecConfig(schedules=ns,
                                 plan=ref_sp.compile_weight_plan(rp, ns))
        pec = pt_engine.shape_exec_config(cfg, shape, params=pp,
                                          device="cpu")
        assert sorted(pec.plan.entries) == sorted(rec.plan.entries)
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    with ref_ops.exec_config(rec):
        want = jax.jit(lambda p, t, f: getattr(ref_model, fn)(
            p, rcfg, {"tokens": t, "frames": f}))(rparams, toks, frames)
    with pt_ops.exec_config(pec):
        got = getattr(pt_model, fn)(
            pparams, cfg, {"tokens": torch.from_numpy(toks).long(),
                           "frames": torch.from_numpy(frames)})
    return np.asarray(want), got.numpy()


def test_encode_matches_reference():
    cfg, rcfg, rp, pp = setup()
    frames = _frames(cfg)
    want = ref_tf.encode(rp["stack"], rcfg, jnp.asarray(frames))
    got = pt_tf.encode(pp["stack"], cfg, torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_forward_hidden_matches_reference(planned):
    want, got = _forward_pair(planned, "forward_hidden")
    assert got.shape == want.shape == (2, 24, 64)
    np.testing.assert_allclose(got, want, **LOGITS)


def test_prefill_is_the_encoders_last_hidden():
    """An encoder-decoder's ``prefill`` is the encoder pass: the last
    frame's encoder output (B, 1, D), not logits, as the reference's."""
    want, got = _forward_pair(False, "prefill")
    assert got.shape == want.shape == (2, 1, 64)
    np.testing.assert_allclose(got, want, **LOGITS)
    cfg, _, _, pp = setup()
    enc = pt_tf.encode(pp["stack"], cfg, torch.from_numpy(_frames(cfg)))
    np.testing.assert_array_equal(got, enc[:, -1:].numpy())


def test_entry_points_refuse_bad_inputs():
    cfg, _, _, pp = setup()
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        pt_model.forward_hidden(pp, cfg, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="token input"):
        pt_model.forward_hidden(pp, cfg, {"tokens": toks,
                                          "frames": torch.zeros(1, 8, 64),
                                          "vis_embeds": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="dense stacks"):
        pt_model.prefill_with_cache(pp, cfg, {"tokens": toks}, 16)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_decode_with_a_filled_memory_matches_reference(planned):
    """Masked decode steps with a random, non-zero cross-attention memory
    (no reference path fills it; here both sides get the same one), so the
    cross-attention really attends: the active rows' logits and the whole
    state.  Under the plan the bare products on ``xattn`` take
    ``PlannedWeight``'s dense route on both sides."""
    cfg, rcfg, rp, pp = setup(planned)
    rec, pec = _plans(planned)
    rparams, pparams = rp, pp
    if planned:
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    rstate = ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ,
                                         dtype=jnp.float32)
    pstate = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                        dtype=torch.float32, device="cpu")
    for i, name in enumerate(("k", "v")):
        mem = _normal(tuple(pstate["memory"][name].shape), 5 + i)
        rstate["memory"][name] = jnp.asarray(mem)
        pstate["memory"][name].copy_(torch.from_numpy(mem))
    rng = np.random.default_rng(1)
    pos = np.array([3, 0, 7, 1], np.int32)
    active = np.array([True, True, False, True])
    ref_step = jax.jit(lambda p, t, s, q, a: ref_model.masked_decode_step(
        p, rcfg, t, s, q, a))
    for _ in range(4):
        toks = rng.integers(0, cfg.vocab, size=(N_SLOTS, 1)).astype(np.int32)
        with ref_ops.exec_config(rec or ref_ops.ExecConfig()):
            rlog, rstate = ref_step(rparams, toks, rstate, pos, active)
        with pt_ops.exec_config(pec or pt_ops.ExecConfig()):
            plog, pstate = pt_model.masked_decode_step(
                pparams, cfg, torch.from_numpy(toks).long(), pstate,
                torch.from_numpy(pos).long(), torch.from_numpy(active))
        np.testing.assert_allclose(plog.numpy()[active],
                                   np.asarray(rlog)[active], **LOGITS)
        theirs = _flat(rstate)
        for path, leaf in _flat(pstate).items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(theirs[path]), **LOGITS,
                                       err_msg=path)
        pos = pos + active
    # the memory moved the logits: a zero memory gives others
    zero = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                      dtype=torch.float32, device="cpu")
    with pt_ops.exec_config(pec or pt_ops.ExecConfig()):
        zlog, _ = pt_model.decode_step(pparams, cfg,
                                       torch.from_numpy(toks).long(), zero,
                                       torch.from_numpy(pos).long())
    assert np.abs(zlog.numpy() - plog.numpy()).max() > 1e-2


def test_a_dtype_changing_carry_raises_on_both_sides():
    """bf16 weights and state under an int8 plan: the cross-attention's
    bare products meet the dequantized float32 weights and promote the
    residual stream to float32; the reference's scan over the decoder
    layers refuses the carry (TypeError), so does the port.  (In float32
    the same plan serves: ``test_engine_streams_equal_reference_engine``.)
    """
    cfg, rcfg, rp, pp = setup(True, dtype="bf16")
    rec, pec = _plans(True, quantize=True, dtype="bf16")
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, quantize=True,
                                  dtype=jnp.bfloat16)
    reng.submit(np.array([3, 5, 7]), max_new=2)
    with pytest.raises(TypeError, match="carry"):
        reng.run_until_drained()
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, quantize=True,
                                 dtype=torch.bfloat16, device="cpu")
    peng.submit(np.array([3, 5, 7]), max_new=2)
    with pytest.raises(TypeError, match="carry"):
        peng.run_until_drained()


# ---------------------------------------------------------------------------
# plans and the serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_plan_metadata_equals_reference(quantize):
    """The decode plan over ``encoder`` / ``decoder`` / ``xattn`` and the
    untied head: the same entries, integer-exact metadata."""
    rec, pec = _plans(True, quantize)
    keys = sorted(pec.plan.entries)
    assert keys == sorted(rec.plan.entries)
    assert any("/xattn/" in k for k in keys)
    assert any(k.startswith("stack/encoder/") for k in keys)
    assert "lm_head" in keys
    for key, e in pec.plan.entries.items():
        r = rec.plan.entries[key]
        assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn,
                e.max_nnz) == (r.site, r.mode, r.bm, r.bk, r.bn, r.tk,
                               r.tn, r.max_nnz), key
        np.testing.assert_array_equal(e.wkidx, r.wkidx)
        np.testing.assert_array_equal(e.wkcnt, r.wkcnt)


@pytest.mark.parametrize("mode", ["dense", "planned", "planned-int8"])
def test_engine_streams_equal_reference_engine(mode):
    """Greedy streams on pinned seeds (float32 weights and state; the
    decode memory is the zeros both sides leave it at)."""
    planned = mode != "dense"
    quantize = mode == "planned-int8"
    cfg, rcfg, rp, pp = setup(planned)
    rec, pec = _plans(planned, quantize)
    prompts = _prompts(cfg)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8,
                                  quantize=quantize)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8,
                                 quantize=quantize, device="cpu")
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want
    assert all(len(s) == 6 for s in got)


def test_fused_engine_equals_step_oracle():
    cfg, rcfg, rp, pp = setup(True)
    _, pec = _plans(True)
    prompts = _prompts(cfg, seed=3)
    outs = []
    for fused in (True, False):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, exec_cfg=pec,
                                    fused=fused, decode_block=4,
                                    device="cpu")
        outs.append(_drain(eng, prompts, max_new=9))
    assert outs[0] == outs[1]


def test_unplanned_int8_raises_on_both_sides():
    """Unplanned, the reference's cross-attention ``wq`` is a
    QuantizedLinear its bare ``@`` cannot take (TypeError when it
    serves); the port refuses at engine construction."""
    cfg, rcfg, rp, pp = setup()
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  quantize=True)
    reng.submit(np.array([3, 5, 7]), max_new=2)
    with pytest.raises(TypeError, match="QuantizedLinear"):
        reng.run_until_drained()
    with pytest.raises(NotImplementedError, match="wq / wo"):
        pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                              quantize=True, device="cpu")
