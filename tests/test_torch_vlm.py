"""The last two configs in the port against the JAX package: M-RoPE
(``rope.apply_rope(kind="mrope")``), the vision prefix (``vis_embeds``
over the leading positions, ``mrope_positions`` through the stack) on
``qwen2-vl-72b``'s smoke config (2 layers, d 64, GQA 8/2, hd 8) and
``llama4-scout-17b-a16e``'s (2 MoE layers, 4 experts top-1 plus one
shared, vision frontend with full rotary); numpy-seeded inputs, float32.

Tolerances, stated per comparison:
  * M-RoPE's cos / sin and the rotated x: atol 5e-6 (|x| ≤ ~4): the two
    sides take float32 cos and sin of the same float32 angles, each from
    its own library (within an ulp), and the frequencies of hd 128 differ
    in the last ulp at a few dims;
  * hidden states and prefill logits: rtol = atol = 1e-4 (the same float32
    products summed in another order through two layers);
  * ``train_loss``: rtol 1e-5, each leaf's gradient within 1e-4·max|ref|
    + 1e-7 (``tests/test_torch_train.py``'s bars);
  * greedy engine streams: token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as ref_sp
from repro.data import pipeline as ref_pipe
from repro.models import model as ref_model
from repro.models import rope as ref_rope
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as pt_pipe
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import model as pt_model
from repro_torch.models import rope as pt_rope
from repro_torch.serve import engine as pt_engine
from repro_torch.train import train_step as pt_step
from test_torch_train import SHAPE, batch_np, close_tree, ref_config

QWEN, LLAMA4 = "qwen2-vl-72b", "llama4-scout-17b-a16e"
ARCHS = [QWEN, LLAMA4]
ROPE_TOL = dict(rtol=0, atol=5e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
N_SLOTS, MAX_SEQ = 2, 32

_TREES = {}


def trees(arch, sparse=False):
    """(cfg, ref cfg, ref float32 params, port params); a sparse config's
    weights are pruned at (16, 16) by the reference's pruner."""
    key = (arch, sparse)
    if key not in _TREES:
        cfg = pt_base.get_smoke_config(arch)
        if sparse:
            cfg = dataclasses.replace(cfg, sparsity=SPARSE)
        rcfg = ref_config(cfg)
        rp = ref_model.init_params(rcfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
        if sparse:
            rp = jax.tree.map(
                lambda leaf: ref_sp.prune_stacked_magnitude(leaf, 0.5,
                                                            (16, 16)), rp)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _TREES[key] = (cfg, rcfg, rp, pp)
    return _TREES[key]


def grid_streams(b, s, n_img, side):
    """(3, B, S) t/h/w streams of a ``side`` × ``side`` patch grid (its
    first n_img = side² positions: t 0, h the row, w the column), then the
    text, all three streams at side + i, as Qwen2-VL numbers them."""
    assert n_img == side * side <= s
    t = np.zeros(n_img, np.int32)
    h = np.repeat(np.arange(side, dtype=np.int32), side)
    w = np.tile(np.arange(side, dtype=np.int32), side)
    text = side + np.arange(s - n_img, dtype=np.int32)
    pos = np.stack([np.concatenate([t, text]), np.concatenate([h, text]),
                    np.concatenate([w, text])])
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))


def vision_batch(cfg, b, s, streams, seed=4):
    """A token batch with the pipeline's frontend inputs (``vis_embeds`` of
    ``n_vis`` rows, t = h = w streams); ``streams="grid"`` replaces the
    streams with a patch grid over the prefix."""
    batch = batch_np(cfg, b, s, seed=seed)
    batch = pt_pipe.with_frontend_inputs(batch, cfg,
                                         n_vis=pt_model.n_vis(cfg, s))
    if streams == "grid":
        n = batch["vis_embeds"].shape[1]
        side = int(np.sqrt(n))
        batch["vis_embeds"] = batch["vis_embeds"][:, :side * side]
        batch["mrope_positions"] = grid_streams(b, s, side * side, side)
    return batch


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [8, 16, 128, 256])
def test_mrope_sections_and_tables_equal_reference(hd):
    rng = np.random.default_rng(hd)
    pos3 = rng.integers(0, 4096, size=(3, 2, 5)).astype(np.int32)
    rc, rs = ref_rope._mrope_cos_sin(jnp.asarray(pos3), hd // 2, 1e6)
    pc, ps = pt_rope._mrope_cos_sin(torch.from_numpy(pos3), hd // 2, 1e6)
    assert pc.dtype == torch.float32 and tuple(pc.shape) == rc.shape
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), **ROPE_TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), **ROPE_TOL)
    sec = pt_rope.mrope_sections(hd // 2)
    assert sum(sec) == hd // 2 and min(sec) >= 1
    if hd == 8:
        assert sec == [1, 2, 1]       # round(1.5) == 2, half to even
    if hd == 128:
        assert tuple(sec) == pt_rope.MROPE_SECTIONS == ref_rope.MROPE_SECTIONS


@pytest.mark.parametrize("streams", ["distinct", "none"])
@pytest.mark.parametrize("hd", [8, 16, 128])
def test_apply_mrope_equals_reference(hd, streams):
    rng = np.random.default_rng(7)
    b, s, h = 2, 24, 3
    x = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    pos = np.ascontiguousarray(
        np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)))
    m = (rng.integers(0, 4096, size=(3, b, s)).astype(np.int32)
         if streams == "distinct" else None)
    want = ref_rope.apply_rope(
        jnp.asarray(x), jnp.asarray(pos), kind="mrope", theta=1e6,
        mrope_positions=None if m is None else jnp.asarray(m))
    got = pt_rope.apply_rope(
        torch.from_numpy(x), torch.from_numpy(pos).long(), kind="mrope",
        theta=1e6, mrope_positions=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)
    if m is None:       # no streams: every stream is the text position
        same = pt_rope.apply_rope(
            torch.from_numpy(x), torch.from_numpy(pos).long(), kind="mrope",
            theta=1e6, mrope_positions=torch.from_numpy(
                np.ascontiguousarray(np.broadcast_to(pos, (3, b, s)))))
        assert torch.equal(got, same)


def test_mrope_sections_follow_streams():
    """The reference's test, mirrored: with t = h = w = the text position
    M-RoPE is the full rotary; perturbing one stream changes the output."""
    b, s, h, hd = 1, 6, 2, 64
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(b, s, h, hd)).astype(np.float32))
    pos = torch.arange(s)[None].expand(b, s)
    same = torch.stack([pos, pos, pos])
    y_same = pt_rope.apply_rope(x, pos, kind="mrope", mrope_positions=same)
    y_full = pt_rope.apply_rope(x, pos, kind="full")
    np.testing.assert_allclose(y_same.numpy(), y_full.numpy(), atol=1e-5)
    diff = same.clone()
    diff[1] = same[1] * 3
    y_diff = pt_rope.apply_rope(x, pos, kind="mrope", mrope_positions=diff)
    assert float((y_diff - y_same).abs().max()) > 1e-4


def test_mrope_changes_qwen_output():
    """The reference's test, mirrored: doubling the streams changes the
    hidden states of the Qwen2-VL smoke config."""
    cfg, _, _, pp = trees(QWEN)
    assert cfg.rope == "mrope"
    batch = to_port(vision_batch(cfg, 1, 16, "pipeline"))
    h1 = pt_model.forward_hidden(pp, cfg, batch, q_chunk=16)
    b2 = dict(batch, mrope_positions=batch["mrope_positions"] * 2)
    h2 = pt_model.forward_hidden(pp, cfg, b2, q_chunk=16)
    assert float((h1 - h2).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# the vision prefix through the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streams", ["pipeline", "grid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_equal_reference(arch, streams):
    """``forward_hidden`` and ``prefill`` with the pipeline's frontend
    inputs (t = h = w) and with a 4 × 4 patch grid's distinct streams."""
    cfg, rcfg, rp, pp = trees(arch)
    batch = vision_batch(cfg, 2, 64, streams)
    assert batch["vis_embeds"].shape[1] == 16
    rb, pb = to_ref(batch), to_port(batch)
    want = ref_model.forward_hidden(rp, rcfg, rb, q_chunk=16)
    got = pt_model.forward_hidden(pp, cfg, pb, q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = ref_model.prefill(rp, rcfg, rb, q_chunk=16)
    got = pt_model.prefill(pp, cfg, pb, q_chunk=16)
    assert got.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the prefix overwrote the leading rows: other token ids there change
    # nothing, and the grid's streams reach a rope="mrope" stack only
    pb2 = dict(pb, tokens=pb["tokens"].clone())
    pb2["tokens"][:, :16] = (pb2["tokens"][:, :16] + 1) % cfg.vocab
    assert torch.equal(pt_model.prefill(pp, cfg, pb2, q_chunk=16), got)
    plain = pt_model.prefill(pp, cfg, {k: v for k, v in pb.items()
                                       if k != "mrope_positions"},
                             q_chunk=16)
    assert torch.equal(plain, got) == (cfg.rope != "mrope"
                                       or streams == "pipeline")


def test_vision_inputs_refused_where_they_do_not_belong():
    cfg, _, _, pp = trees(QWEN)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="vis_embeds"):
        pt_model.forward_hidden(pp, cfg, {
            "tokens": toks, "vis_embeds": torch.zeros(1, 9, cfg.d_model)})
    with pytest.raises(ValueError, match="mrope_positions"):
        pt_model.forward_hidden(pp, cfg, {
            "tokens": toks,
            "mrope_positions": torch.zeros(3, 1, 7, dtype=torch.int32)})
    dense = pt_base.get_smoke_config("stablelm-1.6b")
    dp = pt_model.init_params(dense, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")
    for extra in ({"vis_embeds": torch.zeros(1, 2, dense.d_model)},
                  {"mrope_positions": torch.zeros(3, 1, 8,
                                                  dtype=torch.int32)}):
        with pytest.raises(NotImplementedError, match="token input"):
            pt_model.prefill(dp, dense, {"tokens": toks, **extra})


def test_prefill_with_cache_ignores_vision_inputs():
    """As the reference's: the cache-filling prefill reads tokens only."""
    cfg, _, _, pp = trees(QWEN)
    batch = to_port(vision_batch(cfg, 2, 16, "grid"))
    a, sa = pt_model.prefill_with_cache(pp, cfg, batch, 32,
                                        dtype=torch.float32)
    b, sb = pt_model.prefill_with_cache(pp, cfg, {"tokens": batch["tokens"]},
                                        32, dtype=torch.float32)
    assert torch.equal(a, b) and torch.equal(sa["layers"]["k"],
                                             sb["layers"]["k"])


def test_llama4_stack_has_no_dense_layers():
    cfg, rcfg, rp, pp = trees(LLAMA4)
    assert cfg.moe.first_dense_layers == 0 and cfg.moe.top_k == 1
    assert set(pp["stack"]) == set(rp["stack"]) == {"layers"}
    st = pt_model.init_decode_state(cfg, 2, 8, dtype=torch.float32,
                                    device="cpu")
    assert set(st) == set(ref_model.init_decode_state(rcfg, 2, 8)) \
        == {"layers"}
    e = pp["stack"]["layers"]["moe"]
    assert tuple(e["experts_in"].shape[:2]) == (cfg.n_layers,
                                                cfg.moe.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts(arch):
    from repro.configs import base as ref_base
    ours, ref = pt_base.get_config(arch), ref_base.get_config(arch)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    lo, hi = {QWEN: (60e9, 80e9), LLAMA4: (90e9, 120e9)}[arch]
    assert lo <= ours.param_count() <= hi


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------

def _prompts(cfg, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 9)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_engine_streams_equal_reference_engine(arch):
    """A planned two-sided config (weights pruned 50% at (16, 16)): greedy
    streams token for token, decode through M-RoPE with no streams (Qwen)
    and the top-1 expert route (Llama-4); and fused == ``step()``."""
    cfg, rcfg, rp, pp = trees(arch, sparse=True)
    rec = ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
    pec = pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                       device="cpu")
    assert pec.plan.entries and all(
        d.sparsity_mode == "two_sided" for site, d in
        pec.schedules.sites.items() if site != "lm_head")
    prompts = _prompts(cfg)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=4)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=4, device="cpu")
    got, want = _drain(peng, prompts), _drain(reng, prompts)
    assert got == want and all(len(s) == 6 for s in got)
    oracle = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                   exec_cfg=pec, fused=False, device="cpu")
    assert _drain(oracle, prompts) == got


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_equal_reference(arch):
    """With the vision inputs: a 4 × 4 grid's streams over a 16-row
    prefix."""
    cfg, rcfg, rp, pp = trees(arch)
    batch = vision_batch(cfg, 2, 64, "grid")
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: ref_model.train_loss(p, rcfg, to_ref(batch),
                                       loss_chunk=16, q_chunk=16)))(rp)
    fn = pt_step.loss_for(cfg, dataclasses.replace(
        SHAPE, seq_len=64, global_batch=2, loss_chunk=16, attn_chunk=16))
    with pt_ops.exec_config(pt_ops.ExecConfig()):
        pl, pg = pt_step.value_and_grad(fn, pp, to_port(batch))
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-5)
    close_tree(pg, rg, 1e-4)
    # the prefix's rows take no gradient into the embedding
    g = pg["embed"].clone()
    toks = batch["tokens"]
    only_prefix = set(toks[:, :16].ravel()) - set(toks[:, 16:].ravel())
    for t in only_prefix:
        assert not g[t].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_vision_configs_on_cpu(tmp_path, capsys, arch):
    """The pipeline attaches ``vis_embeds`` and ``mrope_positions`` to a
    vision config's batch (``n_vis`` = S / 4 = 8 rows here)."""
    from repro_torch.launch import train as launch
    log = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--seq", "32",
                       "--n-micro", "2", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in log)
    assert "done: 2 steps" in capsys.readouterr().out


def test_pipeline_frontend_inputs_equal_reference():
    cfg, rcfg, _, _ = trees(QWEN)
    batch = batch_np(cfg, 2, 64, seed=9)
    a = ref_pipe.with_frontend_inputs(batch, rcfg, n_vis=16)
    b = pt_pipe.with_frontend_inputs(batch, cfg, n_vis=16)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert pt_model.n_vis(cfg, 64) == ref_model.n_vis(rcfg, 64) == 16
    assert pt_model.n_vis(cfg, 8192) == 1024


def test_normal_draws_a_leaf_whose_one_layer_exceeds_the_draw_limit(
        monkeypatch):
    """A stacked leaf whose every leading slice is above ``DRAW_ELEMS``
    (Llama-4-Scout's expert leaves: one layer is 16 x 5120 x 8192 =
    671 M draws of 537 M allowed) is drawn index by index; it recursed
    without end before.  A leaf whose slices fit keeps its draws."""
    from repro_torch.models import layers as pt_layers
    monkeypatch.setattr(pt_layers, "DRAW_ELEMS", 64)
    gen = torch.Generator().manual_seed(3)
    big = pt_layers.normal(gen, (3, 4, 8, 8), 0.5, torch.float32)
    assert big.shape == (3, 4, 8, 8)
    assert 0.4 < float(big.std()) < 0.6 and bool(torch.isfinite(big).all())
    # the same draws as drawing each leading index on its own
    gen = torch.Generator().manual_seed(3)
    each = torch.stack([pt_layers.normal(gen, (4, 8, 8), 0.5, torch.float32)
                        for _ in range(3)])
    assert torch.equal(big, each)
    # slices within the limit: unchanged (one draw per slice of the axis)
    gen = torch.Generator().manual_seed(5)
    fit = pt_layers.normal(gen, (6, 2, 4, 4), 1.0, torch.float32)
    gen = torch.Generator().manual_seed(5)
    want = torch.cat([torch.randn((2, 2, 4, 4), generator=gen)
                      for _ in range(3)])
    assert torch.equal(fit, want)
