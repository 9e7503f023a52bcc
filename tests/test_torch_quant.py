"""The port's int8 serving path against the JAX package's: quantization,
quantized plans, the quantized descriptor table, the two int8 kernels'
plain versions and three int8 engines, on numpy-seeded smoke inputs.

Tolerances: int8 payloads, scales and plan metadata are bit- or
integer-exact (both sides compute ``max|w|/127 + 1e-12`` and ``w/scale``
in float32 and round half to even).  The kernels' plain versions and the
Pallas kernels (interpret mode) sum the same float32 products in another
order: rtol = atol = 1e-5 on outputs of order one.  Engines are compared
token for token on pinned seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import descriptors as ref_desc
from repro.core import scheduler as ref_sched
from repro.core import sparsity as ref_sp
from repro.kernels import block_sparse as ref_bs
from repro.kernels import int8_matmul as ref_i8
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.quant import quantize as ref_q
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core import descriptors as pt_desc
from repro_torch.core import scheduler as pt_sched
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.sparsity import iter_leaves
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ref import int8_matmul_ref
from repro_torch.models import model as pt_model
from repro_torch.quant import quantize as pt_q
from repro_torch.serve import engine as pt_engine

ARCHS = ["edge-tiny", "stablelm-1.6b", "yi-9b", "gemma-2b",
         "chatglm3-6b"]
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
N_SLOTS, MAX_SEQ = 4, 40
TOL = dict(rtol=1e-5, atol=1e-5)


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def _ref_leaves(tree, path=()):
    """(key path, leaf) of a reference tree, stopping at QuantizedLinear."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


_CACHE = {}


def setup(arch, planned, tie=False):
    """(port cfg, ref cfg, ref params, port params); planned setups prune
    the weights with the reference's pruner."""
    key = (arch, planned, tie)
    if key not in _CACHE:
        cfg = pt_base.get_smoke_config(arch)
        if tie:
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
        if planned:
            cfg = dataclasses.replace(cfg, sparsity=SPARSE)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
        if planned:
            rp = jax.tree.map(
                lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5,
                                                            (16, 16)), rp)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _CACHE[key] = (cfg, rcfg, rp, pp)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# quantize_params / dequantize_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("tie", [False, True], ids=["head", "tied"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_bit_equal(arch, tie, dtype):
    cfg = pt_base.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, tie_embeddings=tie)
    rp = ref_model.init_params(ref_config(cfg), jax.random.PRNGKey(3),
                               dtype=dtype)
    rq, rstats = ref_q.quantize_params(rp, tie_embeddings=tie)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    pq, pstats = pt_q.quantize_params(pp, tie_embeddings=tie)
    assert pstats == rstats
    ours = dict(iter_leaves(pq))
    theirs = dict(_ref_leaves(rq))
    assert sorted(ours) == sorted(theirs)
    n_quantized = 0
    for path, r in theirs.items():
        p = ours[path]
        if isinstance(r, ref_q.QuantizedLinear):
            n_quantized += 1
            assert isinstance(p, pt_q.QuantizedLinear), path
            assert p.q.dtype == torch.int8 and p.q.is_contiguous(), path
            np.testing.assert_array_equal(p.q.numpy(), np.asarray(r.q))
            assert p.scale.dtype == torch.float32
            np.testing.assert_array_equal(p.scale.numpy().view(np.int32),
                                          np.asarray(r.scale).view(np.int32))
        else:
            np.testing.assert_array_equal(_bits(p), _bits(r))
    assert n_quantized == pstats["n_quantized"]
    layers = pq["stack"]["layers"]
    wq = layers["attn"]["wq"]
    assert wq.scale.shape == (cfg.n_layers, wq.q.shape[-1])   # stacked
    if tie:
        assert "lm_head" not in pq and isinstance(pq["embed"], torch.Tensor)
    else:
        head = pq["lm_head"]
        assert head.q.shape == (cfg.d_model, cfg.vocab)         # (D, V)
        assert head.scale.shape == (cfg.vocab,)


@pytest.mark.parametrize("arch", ARCHS)
def test_dequantize_params_gives_back_the_structure(arch):
    cfg, _, rp, pp = setup(arch, False)
    rq, _ = ref_q.quantize_params(rp)
    pq, _ = pt_q.quantize_params(pp)
    back = pt_q.dequantize_params(pq, dtype=torch.bfloat16)
    ref_back = dict(_ref_leaves(ref_q.dequantize_params(rq,
                                                        dtype=jnp.bfloat16)))
    orig = dict(iter_leaves(pp))
    for path, leaf in iter_leaves(back):
        assert isinstance(leaf, torch.Tensor), path
        assert leaf.shape == orig[path].shape, path
        np.testing.assert_array_equal(_bits(leaf), _bits(ref_back[path]))
    assert sorted(dict(iter_leaves(back))) == sorted(orig)
    # the dequantized head is back in its stored (V, D) orientation; a tied
    # head is the embedding, which is not quantized
    if not cfg.tie_embeddings:
        assert back["lm_head"].is_contiguous()
    # one (K, N) weight: the same bits as the reference's
    wq, rwq = pq["stack"]["layers"]["attn"]["wq"], rq["stack"]["layers"][
        "attn"]["wq"]
    one = pt_q.dequantize_weight(wq.index(0), torch.float32)
    ref_one = ref_q.dequantize_weight(
        ref_q.QuantizedLinear(rwq.q[0], rwq.scale[0]), jnp.float32)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref_one))


# ---------------------------------------------------------------------------
# quantized plan and descriptor table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_plan_equals_reference(arch):
    cfg, rcfg, rp, pp = setup(arch, True)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                        quantize=True)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       quantize=True, device="cpu")
    assert pec.quantize and rec.quantize
    ours, theirs = pec.plan, rec.plan
    assert sorted(ours.entries) == sorted(theirs.entries)
    # a tied head is never planned
    assert ("lm_head" in ours.entries) == (not cfg.tie_embeddings)
    for key, e in ours.entries.items():
        r = theirs.entries[key]
        assert e.quantized and r.quantized and not e.transpose, key
        assert (e.site, e.mode, e.bm, e.bk, e.bn, e.tk, e.tn, e.max_nnz,
                e.lead, e.transpose) == \
            (r.site, r.mode, r.bm, r.bk, r.bn, r.tk, r.tn, r.max_nnz,
             r.lead, r.transpose), key
        np.testing.assert_array_equal(e.wkidx, r.wkidx)
        np.testing.assert_array_equal(e.wkcnt, r.wkcnt)
        np.testing.assert_array_equal(e.b_bitmap, r.b_bitmap)
        assert e.nnz == r.zvc_values.size and e.size == r.zvc_bitmap.size
        assert (e.dense_bytes, e.zvc_bytes, e.int8_zvc_bytes) == \
            (r.dense_bytes, r.zvc_bytes, r.int8_zvc_bytes), key
    for s, d in pec.schedules.sites.items():
        assert d.describe() == rec.schedules.sites[s].describe()
    # attached onto the quantized tree: int8 payloads with their scales,
    # sliced per layer alongside the metadata
    pq, _ = pt_q.quantize_params(pp)
    attached = ours.attach(pq)
    wq = attached["stack"]["layers"]["attn"]["wq"]
    assert wq.quantized and wq.w is pq["stack"]["layers"]["attn"]["wq"].q
    last = wq.index(cfg.n_layers - 1)
    assert torch.equal(last.qscale, pq["stack"]["layers"]["attn"]["wq"]
                       .scale[-1])
    if cfg.tie_embeddings:       # a tied head is never planned
        assert "lm_head" not in attached
    else:
        head = attached["lm_head"]
        assert head.quantized and head.kn.shape == (cfg.d_model, cfg.vocab)


def _table_configs():
    out = []
    for arch, full in (("stablelm-1.6b", False), ("stablelm-1.6b", True),
                       ("edge-tiny", False)):
        cfg = (pt_base.get_config(arch) if full
               else pt_base.get_smoke_config(arch))
        for tie in (False, True):
            c = dataclasses.replace(cfg, tie_embeddings=tie)
            out.append(c)
            out.append(dataclasses.replace(c, sparsity=SPARSE))
    return out


TABLE_CONFIGS = _table_configs()


@pytest.mark.parametrize(
    "cfg", TABLE_CONFIGS,
    ids=[f"{c.name}-{c.d_model}-tie{c.tie_embeddings}-{c.sparsity.enabled}"
         for c in TABLE_CONFIGS])
def test_quantized_table_equals_reference(cfg):
    shape = pt_base.ShapeConfig("serve_decode", "decode", 1, N_SLOTS)
    rshape = ref_base.ShapeConfig("serve_decode", "decode", 1, N_SLOTS)
    ours = pt_desc.compile_network_schedule(cfg, shape, hw=pt_sched.TPU_V5E,
                                            quantize=True)
    theirs = ref_desc.compile_network_schedule(ref_config(cfg), rshape,
                                               hw=ref_sched.TPU_V5E,
                                               quantize=True)
    assert list(ours.sites) == list(theirs.sites)
    for site, d in ours.sites.items():
        r = theirs.sites[site]
        s, t = d.schedule, r.schedule
        assert (d.m, d.n, d.k, d.sparsity_mode) == \
            (r.m, r.n, r.k, r.sparsity_mode), site
        assert (s.stationarity, s.bm, s.bn, s.bk, s.ic_p, s.hbm_bytes,
                s.flops, s.sparsity_mode, s.wt_bytes) == \
            (t.stationarity, t.bm, t.bn, t.bk, t.ic_p, t.hbm_bytes,
             t.flops, t.sparsity_mode, t.wt_bytes), site
        assert d.describe() == r.describe()
    if cfg.tie_embeddings:                 # the tied head keeps 2-byte weights
        assert ours.sites["lm_head"].schedule.wt_bytes == 2


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _int8_operands(rng, m, k, n, a_live=1.0, b_live=1.0, blocks=None):
    """Float32 A, an int8 payload and scales that make outputs of order
    one; with ``blocks`` (bm, bk, bn), A and Q get dead blocks."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    if blocks is not None:
        bm, bk, bn = blocks
        keep_a = rng.random((-(-m // bm), -(-k // bk))) < a_live
        keep_b = rng.random((-(-k // bk), -(-n // bn))) < b_live
        a *= np.repeat(np.repeat(keep_a, bm, 0), bk, 1)[:m, :k]
        q *= np.repeat(np.repeat(keep_b, bk, 0), bn, 1)[:k, :n] \
            .astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, size=n) / (127 * np.sqrt(k))) \
        .astype(np.float32)
    return a, q, scale


@pytest.mark.parametrize("a_live,b_live", [(1.0, 0.5), (0.5, 0.5),
                                           (1.0, 0.0)])
@pytest.mark.parametrize("mkn,blocks", [((4, 128, 192), (4, 32, 64)),
                                        ((32, 64, 96), (16, 16, 32))])
def test_scaled_block_sparse_plain_equals_pallas(a_live, b_live, mkn, blocks):
    m, k, n = mkn
    bm, bk, bn = blocks
    rng = np.random.default_rng(4)
    a, q, scale = _int8_operands(rng, m, k, n, a_live, b_live, blocks)
    a_bm, b_bm = ref_sp.block_bitmap(a, bm, bk), ref_sp.block_bitmap(q, bk, bn)
    ref_meta = ref_sp.build_block_sparse_meta_jnp(jnp.asarray(a_bm),
                                                  jnp.asarray(b_bm))
    ref = ref_bs.block_sparse_matmul(jnp.asarray(a), jnp.asarray(q), ref_meta,
                                     interpret=True, out_dtype=jnp.float32,
                                     scale=jnp.asarray(scale))
    meta = pt_sp.build_block_sparse_meta(torch.from_numpy(a_bm),
                                         torch.from_numpy(b_bm))
    ours = pt_bs.block_sparse_matmul(
        torch.from_numpy(a), torch.from_numpy(q), meta,
        out_dtype=torch.float32, scale=torch.from_numpy(scale))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # skipping never approximates: the dequantized dense product
    dense = a.astype(np.float64) @ (q.astype(np.float64) * scale)
    np.testing.assert_allclose(ours.numpy(), dense, **TOL)


@pytest.mark.parametrize("mkn,blocks", [((4, 200, 72), (128, 128, 128)),
                                        ((6, 256, 384), (4, 128, 64)),
                                        ((33, 96, 50), (16, 32, 16))])
def test_int8_matmul_plain_equals_pallas(mkn, blocks):
    m, k, n = mkn
    bm, bn, bk = blocks
    rng = np.random.default_rng(5)
    a, q, scale = _int8_operands(rng, m, k, n)
    ref = ref_i8.int8_matmul(
        jnp.asarray(a), ref_q.QuantizedLinear(jnp.asarray(q),
                                              jnp.asarray(scale)),
        bm=bm, bn=bn, bk=bk, interpret=True, out_dtype=jnp.float32)
    qw = pt_q.QuantizedLinear(torch.from_numpy(q), torch.from_numpy(scale))
    ours = int8_matmul(torch.from_numpy(a), qw, bm=bm, bn=bn, bk=bk,
                       out_dtype=torch.float32)
    assert ours.shape == (m, n)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    oracle = int8_matmul_ref(torch.from_numpy(a), qw.q, qw.scale)
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), **TOL)
    # bf16 activations: float32 accumulation, one rounding of the result
    out = int8_matmul(torch.from_numpy(a).to(torch.bfloat16), qw)
    assert out.dtype == torch.bfloat16
    exact = torch.from_numpy(a).to(torch.bfloat16).double() @ \
        (qw.q.double() * qw.scale.double())
    assert torch.allclose(out.double(), exact, rtol=2 ** -8, atol=1e-2)


def test_scaled_block_sparse_rows_equals_int8_matmul():
    """``block_sparse_matmul(scale=, rows=2)`` on an A padded to 128 rows
    (the prefill lm_head's plan) returns the product's 2 rows, equal to
    ``int8_matmul`` on the unpadded A and to the Pallas kernel's."""
    m, k, n = 2, 256, 384
    bm, bk, bn = 128, 128, 128
    rng = np.random.default_rng(7)
    a, q, scale = _int8_operands(rng, m, k, n, 1.0, 0.5, (m, bk, bn))
    ap = np.zeros((bm, k), np.float32)
    ap[:m] = a
    meta = pt_sp.build_block_sparse_meta(
        torch.from_numpy(ref_sp.block_bitmap(ap, bm, bk)),
        torch.from_numpy(ref_sp.block_bitmap(q, bk, bn)))
    qw = pt_q.QuantizedLinear(torch.from_numpy(q), torch.from_numpy(scale))
    out = pt_bs.block_sparse_matmul(
        torch.from_numpy(ap), qw.q, meta, out_dtype=torch.float32,
        scale=qw.scale, rows=m)
    dense = int8_matmul(torch.from_numpy(a), qw, out_dtype=torch.float32)
    ref = ref_i8.int8_matmul(
        jnp.asarray(a), ref_q.QuantizedLinear(jnp.asarray(q),
                                              jnp.asarray(scale)),
        interpret=True, out_dtype=jnp.float32)
    assert out.shape == dense.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_int8_kernels_refuse_bad_operands():
    meta = pt_sp.build_block_sparse_meta(torch.ones((1, 2), dtype=torch.bool),
                                         torch.ones((2, 2), dtype=torch.bool))
    a, q = torch.zeros((4, 8)), torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        pt_bs.block_sparse_matmul(a, q.float(), meta, scale=torch.ones(4))
    with pytest.raises(ValueError, match="scale of shape"):
        pt_bs.block_sparse_matmul(a, q, meta, scale=torch.ones(3))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(a, pt_q.QuantizedLinear(q.float(), torch.ones(4)))
    f64 = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="scale of shape"):
        int8_matmul(a, pt_q.QuantizedLinear(q, f64))


# ---------------------------------------------------------------------------
# int8 engines against the reference's
# ---------------------------------------------------------------------------

def _prompts(cfg, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 12)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, max_new=7):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_int8_engine_streams_equal_reference(arch):
    """The planned two-sided int8 engine against the reference's with
    ``use_pallas=False``, whose scaled masked dot is the plain version's
    function."""
    cfg, rcfg, rp, pp = setup(arch, True)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp,
                                        quantize=True)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       quantize=True, device="cpu")
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8, device="cpu")
    assert peng.quantize and peng.quant_stats == reng.quant_stats
    if cfg.tie_embeddings:       # a tied head is never planned
        assert "lm_head" not in peng._exec_params
    else:
        assert isinstance(peng._exec_params["lm_head"],
                          pt_sp.PlannedWeight)
    prompts = _prompts(cfg)
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want
    assert all(len(s) == 7 for s in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_int8_engine_streams_equal_reference(arch):
    """No exec config: every matmul dequantizes to the activation dtype and
    runs as a plain float32 product, on both sides."""
    cfg, rcfg, rp, pp = setup(arch, False)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  decode_block=8, quantize=True)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 decode_block=8, quantize=True, device="cpu")
    prompts = _prompts(cfg, seed=1)
    assert _drain(peng, prompts) == _drain(reng, prompts)


def test_dense_int8_kernel_engine_streams_equal_pallas_engine(monkeypatch):
    """The dense kernel-table int8 engine (every 2-D site through
    ``int8_matmul``) against the reference's with ``use_pallas=True,
    interpret=True`` (its ``_int8_kernel``), prefill included."""
    cfg, rcfg, rp, pp = setup("stablelm-1.6b", False)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, use_pallas=True,
                                        interpret=True, quantize=True)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                       quantize=True, device="cpu")
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[1].q.shape)
        return int8_matmul(*args, **kwargs)
    monkeypatch.setattr(pt_ops, "int8_matmul", counted)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8, device="cpu")
    prompts = _prompts(cfg, seed=5)
    assert _drain(peng, prompts, max_new=5) == _drain(reng, prompts,
                                                      max_new=5)
    # every matmul site went through the int8 kernel's wrapper, head too
    assert (cfg.d_model, cfg.vocab) in calls
    assert len(set(calls)) >= 5
