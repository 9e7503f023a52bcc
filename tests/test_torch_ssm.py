"""The port's SSM family (mamba2-1.3b: Mamba-2 SSD blocks, chunked SSD for
the full sequence, the selective state update at decode) against the JAX
package's, on the smoke config (d 64, 8 SSD heads of 16, d_state 16,
chunk 16) with the reference's weights converted.

Tolerances:
- float32: the two sides sum the same products in orders that may differ
  (einsum contraction orders, the conv's four terms): rtol = atol = 1e-5
  for a block, 1e-4 for logits and the decode state (as
  ``test_torch_serve.py`` holds them).
- bf16 SSD block: both sides round to bf16 at the same points (the
  in-projection, each conv term, the silu, the chunk scores and weights,
  the intra- and inter-chunk products, the chunk states, the sum, the D
  skip, the gated norm, the out-projection), but the float32 sums under
  them may differ in their last bits and so round one bf16 ulp apart;
  the differences that reach the output stay within two bf16 ulps of its
  largest entries (|y| < 4 here: ulp 2⁻⁶) plus one ulp relative:
  atol = 2⁻⁵, rtol = 2⁻⁶.
- bf16 conv and gated norm alone: one rounding apart, rtol = atol = 2⁻⁷.
Greedy streams and plan metadata are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import get_smoke_config as ref_smoke
from repro.core import descriptors as ref_desc
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import model as pt_model
from repro_torch.models import ssm as pt_ssm
from repro_torch.serve import engine as pt_engine

ARCH = "mamba2-1.3b"
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_BLOCK = dict(rtol=2.0 ** -6, atol=2.0 ** -5)
BF16_OP = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
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


def _with_ssm(cfg, **kw):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **kw))


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


def _block(dtype, cfg=None, seed=0):
    """One SSD block's params for ``cfg`` (default: the smoke config),
    drawn by the reference and converted."""
    cfg = cfg or pt_base.get_smoke_config(ARCH)
    rl = ref_ssm.init_ssm(ref_config(cfg), jax.random.PRNGKey(seed),
                          DTYPES[dtype][1])
    return rl, params_from_numpy(jax.tree.map(np.asarray, rl), device="cpu")


# ---------------------------------------------------------------------------
# config and tree
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    for get in ("CONFIG", "smoke_config"):
        import importlib
        ours = getattr(importlib.import_module(
            "repro_torch.configs.mamba2_1_3b"), get)
        theirs = getattr(importlib.import_module(
            "repro.configs.mamba2_1_3b"), get)
        ours = ours() if callable(ours) else ours
        theirs = theirs() if callable(theirs) else theirs
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
    assert pt_base.get_config(ARCH).name == ARCH
    assert ARCH in pt_base.ARCH_IDS
    assert dataclasses.asdict(pt_base.get_smoke_config(ARCH).ssm) == \
        dataclasses.asdict(ref_smoke(ARCH).ssm)


def test_ssm_tree_matches_reference():
    """The port's own init draws the reference's tree (shapes, dtypes) with
    its deterministic leaves: zeros and ones bit for bit, the A_log ramp
    and the dt bias to float32 rounding."""
    cfg, rcfg, rp, _ = setup()
    mine = _flat(pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                      dtype=torch.bfloat16, device="cpu"))
    theirs = _flat(ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in mine.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in theirs.items()}
    for path in ("conv_b", "D", "norm_scale"):
        path = f"stack/layers/ssm/{path}"
        np.testing.assert_array_equal(_np(mine[path]), _np(theirs[path]))
    for path in ("A_log", "dt_bias"):
        path = f"stack/layers/ssm/{path}"
        np.testing.assert_allclose(_np(mine[path]), _np(theirs[path]),
                                   rtol=2.0 ** -22, atol=0)
    # the weights' spread: N(0, 1/d) for in_proj, 0.1 for the conv
    for path, sd in (("in_proj", cfg.d_model ** -0.5), ("conv_w", 0.1)):
        got = float(mine[f"stack/layers/ssm/{path}"].float().std())
        assert abs(got / sd - 1) < 0.1, path
    st = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ, device="cpu")
    rst = ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ)
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flat(st).items()} \
        == {k: (tuple(v.shape), torch.float32)
            for k, v in _flat(rst).items()}
    assert all(str(v.dtype) == "float32" for v in _flat(rst).values())


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_and_gated_norm_match_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, b = (_normal((2, 24, 40), 1), _normal((4, 40), 2) * 0.1,
               _normal((40,), 3))
    want = ref_ssm._causal_conv(*(jnp.asarray(t).astype(jdt)
                                  for t in (x, w, b)))
    got = pt_ssm._causal_conv(*(torch.from_numpy(t).to(tdt)
                                for t in (x, w, b)))
    assert got.dtype == tdt
    tol = F32 if dtype == "f32" else BF16_OP
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    y, z, scale = _normal((2, 24, 40), 4), _normal((2, 24, 40), 5), \
        _normal((40,), 6)
    want = ref_ssm._gated_norm(jnp.asarray(y).astype(jdt),
                               jnp.asarray(z).astype(jdt), jnp.asarray(scale))
    got = pt_ssm._gated_norm(torch.from_numpy(y).to(tdt),
                             torch.from_numpy(z).to(tdt),
                             torch.from_numpy(scale))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk,groups", [(1, 1), (8, 1), (16, 1), (8, 2)],
                         ids=["chunk1", "chunk8", "chunk16",
                              "chunk8-groups2"])
def test_ssd_forward_matches_reference(chunk, groups, dtype):
    """The chunked SSD over S = 32; groups 2 takes the head-repeat path
    (4 heads per group)."""
    cfg = _with_ssm(pt_base.get_smoke_config(ARCH), chunk=chunk,
                    n_groups=groups)
    tdt, jdt = DTYPES[dtype]
    rl, pl = _block(dtype, cfg, seed=chunk + groups)
    x = _normal((2, 32, cfg.d_model), chunk)
    want = ref_ssm.ssd_forward(ref_config(cfg), rl,
                               jnp.asarray(x).astype(jdt))
    got = pt_ssm.ssd_forward(cfg, pl, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "f32" else BF16_BLOCK))


def test_chunk_one_is_the_recurrence():
    """At chunk 1 the chunked form is the stepwise recurrence: the port's
    ``ssd_forward`` against its own ``ssd_decode_step`` fed one token at a
    time, float32, within the reference's 1e-5 (the reference holds the
    same pair to it)."""
    cfg = _with_ssm(pt_base.get_smoke_config(ARCH), chunk=1)
    _, pl = _block("f32", cfg, seed=9)
    x = torch.from_numpy(_normal((2, 24, cfg.d_model), 9))
    full = pt_ssm.ssd_forward(cfg, pl, x)
    st = pt_ssm.init_ssm_state(cfg, 2)
    steps = []
    for t in range(x.shape[1]):
        y, st = pt_ssm.ssd_decode_step(cfg, pl, x[:, t:t + 1], st)
        steps.append(y)
    np.testing.assert_allclose(full.numpy(), torch.cat(steps, 1).numpy(),
                               **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_from_proj_is_ssd_forward_after_its_projection(dtype):
    """``ssd_from_proj`` fed ``x @ in_proj`` is ``ssd_forward`` on x, bit
    for bit (the same operations in the same order)."""
    cfg = pt_base.get_smoke_config(ARCH)
    _, pl = _block(dtype, seed=13)
    x = torch.from_numpy(_normal((2, 32, cfg.d_model), 13)).to(
        DTYPES[dtype][0])
    want = pt_ssm.ssd_forward(cfg, pl, x)
    got = pt_ssm.ssd_from_proj(cfg, pl, torch.matmul(x, pl["in_proj"]))
    assert torch.equal(got, want)


def test_chunked_mask_is_the_references():
    """With chunks longer than one token the reference's intra-chunk mask
    keeps i <= j (ROADMAP queue C): a later token of a chunk moves the
    earlier outputs of that chunk, on both sides alike, and the first
    chunk never sees the second."""
    cfg = pt_base.get_smoke_config(ARCH)
    rl, pl = _block("f32", seed=11)
    x = _normal((1, 32, cfg.d_model), 11)
    x2 = x.copy()
    x2[:, 20] += 1.0
    for fwd in (lambda t: np.asarray(ref_ssm.ssd_forward(
                    ref_config(cfg), rl, jnp.asarray(t))),
                lambda t: pt_ssm.ssd_forward(cfg, pl,
                                             torch.from_numpy(t)).numpy()):
        a, b = fwd(x), fwd(x2)
        assert np.abs(a[:, 16:20] - b[:, 16:20]).max() > 1e-3
        np.testing.assert_array_equal(a[:, :16], b[:, :16])


def test_decay_overflow_matches_reference():
    """The mask's later-token decays are exp of sums of |dt·A| in float32;
    an input 10x the normed scale drives their exponents past 88.72, where
    float32's exp overflows: the same positions go non-finite on both
    sides, and the finite ones agree (a full-width prefill on the card
    reaches such exponents from normed inputs: PERF.md)."""
    cfg = pt_base.get_smoke_config(ARCH)
    rl, pl = _block("f32", seed=21)
    x = _normal((2, 32, cfg.d_model), 21) * 10
    want = np.asarray(ref_ssm.ssd_forward(ref_config(cfg), rl,
                                          jnp.asarray(x)))
    got = pt_ssm.ssd_forward(cfg, pl, torch.from_numpy(x)).numpy()
    ok = np.isfinite(want).all(-1)
    assert 0 < (~ok).sum() < ok.size
    np.testing.assert_array_equal(np.isfinite(got).all(-1), ok)
    np.testing.assert_allclose(got[ok], want[ok], **F32)


def test_indivisible_sequence_raises_on_both_sides():
    """S = 20 at chunk 16: the reference's reshape fails (TypeError); the
    port raises ValueError naming S and the chunk."""
    cfg = pt_base.get_smoke_config(ARCH)
    rl, pl = _block("f32", seed=12)
    x = _normal((1, 20, cfg.d_model), 12)
    with pytest.raises(TypeError):
        ref_ssm.ssd_forward(ref_config(cfg), rl, jnp.asarray(x))
    with pytest.raises(ValueError, match="20 tokens.*chunk 16"):
        pt_ssm.ssd_forward(cfg, pl, torch.from_numpy(x))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_step_matches_reference(dtype):
    """Five steps from a random state: outputs of the active rows, the
    committed state (float32 h and conv window), and the inactive row's
    state untouched bit for bit."""
    cfg = pt_base.get_smoke_config(ARCH)
    tdt, jdt = DTYPES[dtype]
    rl, pl = _block(dtype, seed=13)
    st0 = pt_ssm.init_ssm_state(cfg, N_SLOTS)
    h0 = _normal(tuple(st0["ssm"].shape), 14) * 0.1
    c0 = _normal(tuple(st0["conv"].shape), 15)
    rst = {"ssm": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    pst = {"ssm": torch.from_numpy(h0.copy()),
           "conv": torch.from_numpy(c0.copy())}
    active = torch.tensor([True, False, True, True])
    on = active.numpy()
    tol = F32 if dtype == "f32" else BF16_OP
    for t in range(5):
        x = _normal((N_SLOTS, 1, cfg.d_model), 16 + t)
        want, new = ref_ssm.ssd_decode_step(ref_config(cfg), rl,
                                            jnp.asarray(x).astype(jdt), rst)
        rst = {k: jnp.where(jnp.asarray(on).reshape(
            (-1,) + (1,) * (v.ndim - 1)), new[k], v) for k, v in rst.items()}
        got, pst = pt_ssm.ssd_decode_step(cfg, pl,
                                          torch.from_numpy(x).to(tdt), pst,
                                          active=active)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got)[on], _np(want)[on], **tol)
        for k in ("ssm", "conv"):
            assert pst[k].dtype == torch.float32
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(rst[k]),
                                       **LOGITS, err_msg=k)
    np.testing.assert_array_equal(pst["ssm"].numpy()[~on], h0[~on])
    np.testing.assert_array_equal(pst["conv"].numpy()[~on], c0[~on])


# ---------------------------------------------------------------------------
# the model: prefill, decode, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_prefill_logits_match_reference(planned):
    """S = 32 (two chunks).  The sparse config compiles an empty plan on
    both sides: no ``ssm`` site is plannable and the tied head never is."""
    cfg, rcfg, rp, pp = setup(planned)
    b, s = 2, 32
    toks = _tokens(cfg, b, s, seed=s)
    rec, pec = ref_ops.ExecConfig(), pt_ops.ExecConfig()
    if planned:
        shape = pt_base.ShapeConfig("prefill", "prefill", s, b)
        rec = ref_ops.ExecConfig(
            schedules=ref_desc.compile_network_schedule(rcfg, shape))
        pec = pt_engine.shape_exec_config(cfg, shape, params=pp,
                                          device="cpu")
        assert pec.plan is None
    with ref_ops.exec_config(rec):
        rlog = jax.jit(lambda p, t: ref_model.prefill(
            p, rcfg, {"tokens": t}))(rp, toks)
    with pt_ops.exec_config(pec):
        plog = pt_model.prefill(pp, cfg,
                                {"tokens": torch.from_numpy(toks).long()})
    assert plog.shape == (b, 1, cfg.vocab)
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **LOGITS)


def test_plan_metadata_equals_reference():
    """The decode table and plan: the same descriptor sites and schedules
    on both sides (``ssm.in_proj`` / ``ssm.out_proj`` and the dense tied
    head), and no plan (nothing plannable), as the reference compiles."""
    cfg, rcfg, rp, pp = setup(True)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       device="cpu")
    assert rec.plan is None and pec.plan is None
    rs, ps = rec.schedules.sites, pec.schedules.sites
    assert sorted(ps) == sorted(rs) == ["lm_head", "ssm.in_proj",
                                        "ssm.out_proj"]
    for site, d in ps.items():
        r = rs[site]
        assert (d.m, d.n, d.k, d.sparsity_mode) == \
            (r.m, r.n, r.k, r.sparsity_mode), site
        assert (d.schedule.stationarity, d.schedule.bm, d.schedule.bn,
                d.schedule.bk) == (r.schedule.stationarity, r.schedule.bm,
                                   r.schedule.bn, r.schedule.bk), site
    from repro_torch.core.sparsity import compile_weight_plan
    plan = compile_weight_plan(pp, pec.schedules)
    rplan = ref_sp.compile_weight_plan(rp, rec.schedules)
    assert sorted(plan.entries) == sorted(rplan.entries) == []


def test_prefill_with_cache_refuses_ssm():
    cfg, _, _, pp = setup()
    with pytest.raises(NotImplementedError, match="dense stacks"):
        pt_model.prefill_with_cache(
            pp, cfg, {"tokens": torch.zeros((1, 16), dtype=torch.long)}, 32)


def test_decode_step_logits_and_state_match():
    """Masked decode steps: the active rows' logits and the whole
    state."""
    cfg, rcfg, rp, pp = setup()
    rstate = ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ)
    pstate = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    pos = np.array([3, 0, 7, 1], np.int32)
    active = np.array([True, True, False, True])
    ref_step = jax.jit(lambda p, t, s, q, a: ref_model.masked_decode_step(
        p, rcfg, t, s, q, a))
    for _ in range(5):
        toks = rng.integers(0, cfg.vocab, size=(N_SLOTS, 1)).astype(np.int32)
        rlog, rstate = ref_step(rp, toks, rstate, pos, active)
        plog, pstate = pt_model.masked_decode_step(
            pp, cfg, torch.from_numpy(toks).long(), pstate,
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

@pytest.mark.parametrize("mode", ["dense", "planned", "chunked"])
def test_engine_streams_equal_reference_engine(mode):
    """Greedy streams on pinned seeds: the dense config, the sparse config
    (pruned weights, its empty plan) and chunked admission (chunks of 3)."""
    planned = mode == "planned"
    cfg, rcfg, rp, pp = setup(planned)
    rec = pec = None
    if planned:
        rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
        pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                           device="cpu")
    chunk = 3 if mode == "chunked" else None
    prompts = _prompts(cfg)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8,
                                  prefill_chunk=chunk)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8,
                                 prefill_chunk=chunk, device="cpu")
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want
    assert all(len(s) == 6 for s in got)


def test_reference_stream_on_the_pinned_prompt():
    """The reference's own greedy stream on prompt [3, 5, 7] (seed 0,
    float32, 4 new tokens) is [163, 171, 106, 83]; so is the port's."""
    cfg, rcfg, rp, pp = setup()
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                device="cpu")
    assert _drain(eng, [np.array([3, 5, 7])], max_new=4) == \
        [[163, 171, 106, 83]]


def test_fused_engine_equals_step_oracle_and_speculation_stays_off():
    cfg, _, _, pp = setup()
    prompts = _prompts(cfg, seed=3)
    outs = []
    for fused in (True, False):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, fused=fused,
                                    decode_block=4, device="cpu")
        outs.append(_drain(eng, prompts, max_new=9))
    assert outs[0] == outs[1]
    spec = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 speculate_k=3, decode_block=4, device="cpu")
    assert not spec._spec_windowed
    assert _drain(spec, prompts, max_new=9) == outs[0]
    assert spec.spec_stats["verify_blocks"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "step"])
def test_reused_slot_gives_a_fresh_stream(fused):
    """A slot freed by a finished request is zero-reset before the next
    (the SSD state and the conv window): the second request through a
    1-slot engine emits what it emits in a fresh engine."""
    cfg, _, _, pp = setup()
    prompts = _prompts(cfg, seed=6, n=2)
    fresh = pt_engine.ServeEngine(cfg, pp, n_slots=1, max_seq=MAX_SEQ,
                                  device="cpu")
    alone = _drain(fresh, prompts[1:])[0]
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=1, max_seq=MAX_SEQ,
                                fused=fused, device="cpu")
    first, second = _drain(eng, prompts)
    assert len(first) == 6
    assert second == alone


def test_prefill_into_slot_resets_every_state_leaf():
    cfg, _, _, pp = setup()
    state = pt_model.init_decode_state(cfg, 2, MAX_SEQ, device="cpu")
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

@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_int8_raises_on_both_sides(planned):
    """The reference's quantized in_proj is a QuantizedLinear that its bare
    ``@`` cannot take (TypeError when it serves); the port refuses at
    engine construction with NotImplementedError naming that."""
    cfg, rcfg, rp, pp = setup(planned)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                        quantize=True) if planned else None
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, quantize=True)
    reng.submit(np.array([3, 5, 7]), max_new=2)
    with pytest.raises(TypeError, match="QuantizedLinear"):
        reng.run_until_drained()
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       quantize=True, device="cpu") \
        if planned else None
    with pytest.raises(NotImplementedError, match="in_proj"):
        pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                              exec_cfg=pec, quantize=True, device="cpu")
