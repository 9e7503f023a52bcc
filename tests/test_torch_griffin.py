"""The port's Griffin family (recurrentgemma-9b: RG-LRU recurrent blocks
and sliding-window attention in (rec, rec, attn) groups, then trailing
recurrent layers) against the JAX package's, on the smoke config (window
32) with the reference's weights converted.

Tolerances:
- float32: the port scans the recurrence in log depth, the reference with
  ``jax.lax.associative_scan``, so the two differ in the order of the
  float32 combines and of the matmul sums only: rtol = atol = 1e-5 for a
  block or a group, 1e-4 for logits (as ``test_torch_serve.py`` holds
  them).
- bf16 recurrent block: the conv, the gates and the gelu product round to
  bf16 on both sides, in orders that may differ: one bf16 ulp of the
  output at any magnitude, rtol = atol = 2⁻⁷.
- bf16 group (the windowed attention inside it): the reference rounds the
  scores to bf16 before the softmax, so a score whose float32 sum differs
  in its last bits moves its weight by a bf16 ulp of the score (2⁻⁸·|s|,
  |s| ≲ 4): rtol = atol = 2⁻⁵, as ``test_torch_prefill.py`` holds the
  dense oracle.
Greedy streams and plan metadata are compared exactly.
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
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.models import rglru as ref_rglru
from repro.models import transformer as ref_tf
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import ref as pt_ref
from repro_torch.models import attention as pt_attn
from repro_torch.models import model as pt_model
from repro_torch.models import rglru as pt_rglru
from repro_torch.models import transformer as pt_tf
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine

ARCH = "recurrentgemma-9b"
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_BLOCK = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
BF16_ATTN = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# 4 slots; a cache of 64 positions, so a rolling window of 32 wraps for
# prompts and streams that pass position 32
N_SLOTS, MAX_SEQ = 4, 64


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
    """Prompts of 2 to 39 tokens: with 7 new tokens the longer ones pass
    position 32, where the rolling cache of the attention blocks wraps
    (seed 0: 34, 22, 38 and 5 tokens)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 40)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, max_new=7):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


def _layer(tree, i=0):
    return jax.tree.map(lambda leaf: leaf[i], tree)


# ---------------------------------------------------------------------------
# the recurrent block
# ---------------------------------------------------------------------------

def test_griffin_layout_and_tree_match_reference():
    cfg, rcfg, rp, pp = setup()
    assert pt_tf.griffin_layout(cfg) == ref_tf.griffin_layout(rcfg) == (1, 2)
    ours = {k: tuple(v.shape) for k, v in _flat(pp).items()}
    theirs = {k: tuple(v.shape) for k, v in _flat(rp).items()}
    assert ours == theirs
    # the port's own init draws the same tree, with the reference's
    # deterministic leaves: the zeros bit for bit, the Λ ramp to float32
    # rounding (the two linspaces round their steps differently)
    mine = _flat(pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                      dtype=torch.float32, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == theirs
    for path in ("stack/trailing/rglru/b_a", "stack/trailing/rglru/conv_b"):
        np.testing.assert_array_equal(mine[path].numpy(),
                                      _np(_flat(rp)[path]))
    np.testing.assert_allclose(mine["stack/groups/b0_rec/rglru/lam"].numpy(),
                               _np(_flat(rp)["stack/groups/b0_rec/rglru/lam"]),
                               rtol=2.0 ** -23, atol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_forward_matches_reference(dtype):
    cfg, rcfg, rp, pp = setup(dtype=dtype)
    tdt, jdt = DTYPES[dtype]
    x = _normal((2, 64, cfg.d_model), 1)
    rl = _layer(rp["stack"]["groups"]["b0_rec"]["rglru"])
    pl = pt_tf.index_tree(pp["stack"]["groups"]["b0_rec"]["rglru"], 0)
    want = ref_rglru.rglru_forward(rl, rcfg, jnp.asarray(x).astype(jdt))
    got = pt_rglru.rglru_forward(pl, cfg, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_BLOCK))


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the plain loop h_t = a_t·h_{t-1} + b_t
    in float64 (exact to float64 rounding, rtol 1e-12)."""
    rng = np.random.default_rng(5)
    for s in (1, 2, 7, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)))
        b = torch.from_numpy(rng.normal(size=(2, s, 3)))
        h, want = torch.zeros(2, 3, dtype=torch.float64), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(pt_rglru.linear_scan(a, b).numpy(),
                                   torch.stack(want, 1).numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_decode_step_matches_reference(dtype):
    cfg, rcfg, rp, pp = setup(dtype=dtype)
    tdt, jdt = DTYPES[dtype]
    w = cfg.rglru.lru_width
    h0 = _normal((N_SLOTS, w), 2)
    conv0 = _normal((N_SLOTS, cfg.rglru.d_conv - 1, w), 3)
    x = _normal((N_SLOTS, 1, cfg.d_model), 4)
    rl = _layer(rp["stack"]["trailing"]["rglru"], 1)
    pl = pt_tf.index_tree(pp["stack"]["trailing"]["rglru"], 1)
    want, rst = ref_rglru.rglru_decode_step(
        rl, rcfg, jnp.asarray(x).astype(jdt),
        {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0).astype(jdt)})
    active = torch.tensor([True, False, True, True])
    pst = {"h": torch.from_numpy(h0.copy()),
           "conv": torch.from_numpy(conv0).to(tdt)}
    conv_before = pst["conv"].clone()
    got, pst = pt_rglru.rglru_decode_step(pl, cfg,
                                          torch.from_numpy(x).to(tdt), pst,
                                          active=active)
    tol = F32 if dtype == "f32" else BF16_BLOCK
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    on = active.numpy()
    np.testing.assert_allclose(pst["h"].numpy()[on], _np(rst["h"])[on],
                               **tol)
    np.testing.assert_array_equal(_np(pst["conv"])[on],
                                  _np(rst["conv"])[on])
    # the inactive row keeps its state bit for bit
    np.testing.assert_array_equal(pst["h"].numpy()[~on], h0[~on])
    assert torch.equal(pst["conv"][~on], conv_before[~on])


# ---------------------------------------------------------------------------
# windowed attention and the group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [64, 96])
def test_windowed_attention_matches_reference(s, dtype):
    """The plain windowed branch (S > window 32), the reference's
    ``windowed_attention`` copied, in 32-row query chunks."""
    tdt, jdt = DTYPES[dtype]
    q = _normal((2, s, 1, 4, 16), s)
    k, v = _normal((2, s, 1, 16), s + 1), _normal((2, s, 1, 16), s + 2)
    want = ref_attn.windowed_attention(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), window=32,
        q_chunk=32)
    got = pt_ref.windowed_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), window=32,
        q_chunk=32)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_ATTN))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_windowed_attention_forward_matches_reference(use_kernels, dtype):
    """``attention_forward`` at S = 128 > window 32.  Plain: the port's
    ``windowed_attention`` on the flattened heads.  ``use_kernels``: the
    flash wrapper with the window, which on CPU tensors runs its plain
    version in the kernel's order (no launch counted); the wrapper takes
    head dims 32 to 256, so the heads are widened to 32 on both sides."""
    cfg, _, _, _ = setup()
    cfg = dataclasses.replace(cfg, head_dim=32)
    rcfg = ref_config(cfg)
    tdt, jdt = DTYPES[dtype]
    rp = ref_model.init_params(rcfg, jax.random.PRNGKey(1), dtype=jdt)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    s = 128
    x = _normal((2, s, cfg.d_model), 6)
    positions = np.broadcast_to(np.arange(s)[None], (2, s))
    rl = _layer(rp["stack"]["groups"]["b2_attn"]["attn"])
    pl = pt_tf.index_tree(pp["stack"]["groups"]["b2_attn"]["attn"], 0)
    want = ref_attn.attention_forward(rl, rcfg, jnp.asarray(x).astype(jdt),
                                      positions=jnp.asarray(positions),
                                      window=cfg.window)
    before = dict(pt_fa.LAUNCHES)
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=use_kernels)):
        got = pt_attn.attention_forward(
            pl, cfg, torch.from_numpy(x).to(tdt),
            positions=torch.from_numpy(positions.copy()), window=cfg.window)
    assert pt_fa.LAUNCHES == before
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_ATTN))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_griffin_group_matches_reference(dtype):
    """One (rec, rec, attn) group over S = 64 (the windowed branch)."""
    cfg, rcfg, rp, pp = setup(dtype=dtype)
    tdt, jdt = DTYPES[dtype]
    s = 64
    x = _normal((2, s, cfg.d_model), 7)
    positions = np.broadcast_to(np.arange(s)[None], (2, s))
    want = ref_tf.apply_griffin_group(_layer(rp["stack"]["groups"]), rcfg,
                                      jnp.asarray(x).astype(jdt),
                                      positions=jnp.asarray(positions))
    got = pt_tf.apply_griffin_group(
        pt_tf.index_tree(pp["stack"]["groups"], 0), cfg,
        torch.from_numpy(x).to(tdt),
        positions=torch.from_numpy(positions.copy()))
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_ATTN))


# ---------------------------------------------------------------------------
# the model: prefill, decode, plans
# ---------------------------------------------------------------------------

def _ref_shape_exec(rcfg, shape, rp, quantize=False):
    """The reference's ``decode_exec_config`` recipe at another shape."""
    ns = ref_desc.compile_network_schedule(rcfg, shape, quantize=quantize)
    if quantize:
        rp, _ = ref_q.quantize_params(rp, tie_embeddings=rcfg.tie_embeddings)
    measured = ref_sp.measure_weight_densities(rp, ns)
    ns = ref_desc.compile_network_schedule(rcfg, shape, wt_densities=measured,
                                           quantize=quantize)
    plan = ref_sp.compile_weight_plan(rp, ns,
                                      ref_elem_bytes=2 if quantize else None)
    return ref_ops.ExecConfig(schedules=ns, plan=plan, quantize=quantize)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
@pytest.mark.parametrize("s", [24, 64])
def test_prefill_logits_match_reference(s, planned):
    """S = 24 takes the dense masked branch of the attention blocks, S =
    64 the windowed one."""
    cfg, rcfg, rp, pp = setup(planned)
    b = 2
    toks = _tokens(cfg, b, s, seed=s)
    rec, pec = ref_ops.ExecConfig(), pt_ops.ExecConfig()
    rparams, pparams = rp, pp
    if planned:
        shape = pt_base.ShapeConfig("prefill", "prefill", s, b)
        rec = _ref_shape_exec(rcfg, shape, rp)
        pec = pt_engine.shape_exec_config(cfg, shape, params=pp,
                                          device="cpu")
        assert sorted(pec.plan.entries) == sorted(rec.plan.entries)
        assert any("/rglru/" in k for k in pec.plan.entries)
        for key, e in pec.plan.entries.items():
            r = rec.plan.entries[key]
            assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn,
                    e.max_nnz) == (r.site, r.mode, r.bm, r.bk, r.bn, r.tk,
                                   r.tn, r.max_nnz), key
            np.testing.assert_array_equal(e.wkidx, r.wkidx)
            np.testing.assert_array_equal(e.wkcnt, r.wkcnt)
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    with ref_ops.exec_config(rec):
        rlog = jax.jit(lambda p, t: ref_model.prefill(
            p, rcfg, {"tokens": t}))(rparams, toks)
    with pt_ops.exec_config(pec):
        plog = pt_model.prefill(pparams, cfg,
                                {"tokens": torch.from_numpy(toks).long()})
    assert plog.shape == (b, 1, cfg.vocab)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **LOGITS)


def test_prefill_with_cache_refuses_griffin():
    """The reference's cache-filling prefill is dense-only; so is the
    port's (the engine feeds Griffin prompts token by token)."""
    cfg, _, _, pp = setup()
    with pytest.raises(NotImplementedError, match="dense stacks"):
        pt_model.prefill_with_cache(pp, cfg,
                                    {"tokens": torch.zeros((1, 8),
                                                           dtype=torch.long)},
                                    16)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_decode_step_logits_and_state_match(planned):
    """Masked decode steps past the window (positions 30..35 wrap the
    rolling cache of 32): the active rows' logits and the whole state."""
    cfg, rcfg, rp, pp = setup(planned)
    rec = pec = None
    rparams, pparams = rp, pp
    if planned:
        rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
        pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                           device="cpu")
        rparams, pparams = rec.plan.attach(rp), pec.plan.attach(pp)
    rstate = ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ,
                                         dtype=jnp.float32)
    pstate = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                        dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(pstate).items()} == \
        {k: tuple(v.shape) for k, v in _flat(rstate).items()}
    rng = np.random.default_rng(1)
    pos = np.array([30, 0, 31, 28], np.int32)
    active = np.array([True, True, False, True])
    ref_step = jax.jit(lambda p, t, s, q, a: ref_model.masked_decode_step(
        p, rcfg, t, s, q, a))
    for _ in range(6):
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


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _exec(cfg, rcfg, rp, pp, planned, quantize=False):
    if not planned:
        return None, None
    return (ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                          quantize=quantize),
            pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                         quantize=quantize, device="cpu"))


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_engine_streams_equal_reference_engine(planned):
    cfg, rcfg, rp, pp = setup(planned)
    rec, pec = _exec(cfg, rcfg, rp, pp, planned)
    prompts = _prompts(cfg)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8, device="cpu")
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want
    assert all(len(s) == 7 for s in got)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_fused_engine_equals_step_oracle(planned):
    cfg, rcfg, rp, pp = setup(planned)
    _, pec = _exec(cfg, rcfg, rp, pp, planned)
    prompts = _prompts(cfg, seed=3)
    outs = []
    for fused in (True, False):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, exec_cfg=pec,
                                    fused=fused, decode_block=4,
                                    device="cpu")
        outs.append(_drain(eng, prompts, max_new=9))
    assert outs[0] == outs[1]


def test_speculation_stays_off():
    """A verify window is not a decode step's equal for recurrent state,
    so the engine serves Griffin without speculating (as the reference)."""
    cfg, _, _, pp = setup()
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                speculate_k=3, device="cpu")
    assert not eng._spec_windowed
    got = _drain(eng, _prompts(cfg, seed=4, n=3), max_new=5)
    plain = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  device="cpu")
    assert got == _drain(plain, _prompts(cfg, seed=4, n=3), max_new=5)
    assert eng.spec_stats["verify_blocks"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "step"])
def test_reused_slot_gives_a_fresh_stream(fused):
    """A slot freed by a finished request is zero-reset before the next
    (the recurrent h and conv too, three levels deep in the state): the
    second request through a 1-slot engine emits what it emits in a fresh
    engine, and what the reference's fresh engine emits."""
    cfg, rcfg, rp, pp = setup()
    prompts = _prompts(cfg, seed=6, n=2)
    fresh = pt_engine.ServeEngine(cfg, pp, n_slots=1, max_seq=MAX_SEQ,
                                  device="cpu")
    alone = _drain(fresh, prompts[1:], max_new=6)[0]
    ref_fresh = ref_engine.ServeEngine(rcfg, rp, n_slots=1, max_seq=MAX_SEQ)
    assert alone == _drain(ref_fresh, prompts[1:], max_new=6)[0]
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=1, max_seq=MAX_SEQ,
                                fused=fused, device="cpu")
    first, second = _drain(eng, prompts, max_new=6)
    assert len(first) == 6
    assert second == alone


def test_prefill_into_slot_resets_every_state_leaf():
    cfg, _, _, pp = setup()
    state = pt_model.init_decode_state(cfg, 2, MAX_SEQ, dtype=torch.float32,
                                       device="cpu")
    for leaf in _flat(state).values():
        leaf.fill_(7.0)
    state = pt_model.prefill_into_slot(pp, cfg, np.zeros(1, np.int32),
                                       np.zeros(1, bool), 1, state,
                                       torch.zeros(2, dtype=torch.long))
    for path, leaf in _flat(state).items():
        assert torch.all(leaf[:, 1] == 0), path
        assert torch.all(leaf[:, 0] == 7.0), path


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def test_quantized_tree_and_plan_equal_reference():
    """``quantize_params`` over the deeper tree (groups / b{i}_{kind},
    trailing): the same leaves quantized, payloads and scales bit-equal;
    the int8 plan's metadata integer-exact (the tied head unplanned)."""
    cfg, rcfg, rp, pp = setup(True)
    rq, rstats = ref_q.quantize_params(rp, tie_embeddings=True)
    pq, pstats = pt_q.quantize_params(pp, tie_embeddings=True)
    # six matmul leaves in each of b0_rec, b1_rec, b2_attn and trailing
    assert pstats == rstats and pstats["n_quantized"] == 24
    theirs = _flat(rq)
    for path, leaf in _flat(pq).items():
        r = theirs[path]
        if isinstance(r, ref_q.QuantizedLinear):
            assert isinstance(leaf, pt_q.QuantizedLinear), path
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(r.q))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(r.scale))
        else:
            assert not isinstance(leaf, pt_q.QuantizedLinear), path
    rec, pec = _exec(cfg, rcfg, rp, pp, True, quantize=True)
    assert sorted(pec.plan.entries) == sorted(rec.plan.entries)
    assert "lm_head" not in pec.plan.entries
    for key, e in pec.plan.entries.items():
        r = rec.plan.entries[key]
        assert e.quantized and r.quantized, key
        assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn, e.max_nnz,
                e.lead) == (r.site, r.mode, r.bm, r.bk, r.bn, r.tk, r.tn,
                            r.max_nnz, r.lead), key
        np.testing.assert_array_equal(e.wkidx, r.wkidx)
        np.testing.assert_array_equal(e.b_bitmap, r.b_bitmap)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_int8_engine_streams_equal_reference(planned):
    cfg, rcfg, rp, pp = setup(planned)
    if planned:
        rec, pec = _exec(cfg, rcfg, rp, pp, True, quantize=True)
    else:
        rec = ref_ops.ExecConfig(quantize=True)
        pec = pt_ops.ExecConfig(quantize=True)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8, device="cpu")
    assert peng.quantize and peng.quant_stats == reng.quant_stats
    prompts = _prompts(cfg, seed=8)
    assert _drain(peng, prompts) == _drain(reng, prompts)
