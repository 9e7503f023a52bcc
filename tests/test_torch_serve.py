"""The port's model and serving engine against the JAX package's, on the
same weights (the reference's init, converted) and the same prompts.

Tolerance for logits: both sides compute in float32 and differ only in the
order of summation (XLA's dots vs the port's float32-accumulated products),
so per-step logits agree to ~1e-6; the bar is atol = rtol = 1e-4.  Greedy
streams are compared token for token on pinned seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import sparsity as ref_sp
from repro.kernels import ops as ref_ops
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as pt_ops
from repro_torch.models import model as pt_model
from repro_torch.serve import engine as pt_engine

ARCHS = ["edge-tiny", "stablelm-1.6b", "yi-9b", "gemma-2b",
         "chatglm3-6b"]
SPARSE = pt_base.SparsityConfig(weight_sparsity=0.5,
                                activation_threshold=0.05)
N_SLOTS, MAX_SEQ = 4, 40


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


_CACHE = {}


def setup(arch, planned):
    """(port cfg, ref cfg, ref params, port params, ref exec, port exec);
    planned setups prune the weights with the reference's pruner."""
    key = (arch, planned)
    if key not in _CACHE:
        cfg = pt_base.get_smoke_config(arch)
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
        rec = (ref_engine.decode_exec_config(rcfg, N_SLOTS, params=rp)
               if planned else None)
        pec = (pt_engine.decode_exec_config(cfg, N_SLOTS, params=pp,
                                            device="cpu")
               if planned else None)
        _CACHE[key] = (cfg, rcfg, rp, pp, rec, pec)
    return _CACHE[key]


def _prompts(cfg, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 12)))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match(arch, planned):
    cfg, rcfg, rp, pp, rec, pec = setup(arch, planned)
    rparams = rec.plan.attach(rp) if planned else rp
    pparams = pec.plan.attach(pp) if planned else pp
    rstate = ref_model.init_decode_state(rcfg, N_SLOTS, MAX_SEQ,
                                         dtype=jnp.float32)
    pstate = pt_model.init_decode_state(cfg, N_SLOTS, MAX_SEQ,
                                        dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    pos = np.array([0, 3, 1, 5], np.int32)
    active = np.array([True, True, False, True])
    ref_step = jax.jit(lambda p, t, s, q, a: ref_model.masked_decode_step(
        p, rcfg, t, s, q, a))
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, size=(N_SLOTS, 1)).astype(np.int32)
        with ref_ops.exec_config(rec or ref_ops.ExecConfig()):
            rlog, rstate = ref_step(rparams, toks, rstate, pos, active)
        with pt_ops.exec_config(pec or pt_ops.ExecConfig()):
            plog, pstate = pt_model.masked_decode_step(
                pparams, cfg, torch.from_numpy(toks).long(), pstate,
                torch.from_numpy(pos).long(), torch.from_numpy(active))
        # inactive rows' logits are discarded by every caller (the port
        # does not write their cache row before attending); compare the rest
        np.testing.assert_allclose(plog.numpy()[active],
                                   np.asarray(rlog)[active],
                                   rtol=1e-4, atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                pstate["layers"][name].numpy(),
                np.asarray(rstate["layers"][name]), rtol=1e-4, atol=1e-4)
        pos = pos + active


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_streams_equal_reference_engine(arch, planned):
    cfg, rcfg, rp, pp, rec, pec = setup(arch, planned)
    prompts = _prompts(cfg)
    reng = ref_engine.ServeEngine(rcfg, rp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                  exec_cfg=rec, decode_block=8)
    peng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                 exec_cfg=pec, decode_block=8, device="cpu")
    ruids = [reng.submit(p, max_new=7) for p in prompts]
    puids = [peng.submit(p, max_new=7) for p in prompts]
    rres, pres = reng.run_until_drained(), peng.run_until_drained()
    assert [pres[u] for u in puids] == [rres[u] for u in ruids]
    assert all(len(pres[u]) == 7 for u in puids)


@pytest.mark.parametrize("planned", [False, True], ids=["dense", "planned"])
def test_fused_engine_equals_step_oracle(planned):
    cfg, _, _, pp, _, pec = setup("stablelm-1.6b", planned)
    prompts = _prompts(cfg, seed=3, n=7)

    def drain(fused, eos_id=None):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS,
                                    max_seq=MAX_SEQ, exec_cfg=pec,
                                    fused=fused, decode_block=4,
                                    eos_id=eos_id, device="cpu")
        uids = [eng.submit(p, max_new=9) for p in prompts]
        res = eng.run_until_drained()
        return [res[u] for u in uids]

    fused = drain(True)
    assert fused == drain(False)
    # an EOS that some stream emits mid-way stops that row on the device
    eos = fused[0][3]
    stopped = drain(True, eos_id=eos)
    assert stopped == drain(False, eos_id=eos)
    assert stopped[0] == fused[0][:fused[0].index(eos) + 1]


def test_dense_kernel_table_engine_equals_plain_engine():
    """Dense sites routed through the flex-matmul wrappers (output- and
    input-stationary sites on the smoke table) emit the plain engine's
    tokens."""
    cfg, _, _, pp, _, _ = setup("stablelm-1.6b", False)
    ec = pt_engine.decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                      device="cpu")
    stats = {d.schedule.stationarity for d in ec.schedules.sites.values()}
    assert stats >= {"output", "input"}
    outs = []
    for exec_cfg in (None, ec):
        eng = pt_engine.ServeEngine(cfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                    exec_cfg=exec_cfg, device="cpu")
        uids = [eng.submit(p, max_new=5) for p in _prompts(cfg, seed=5)]
        res = eng.run_until_drained()
        outs.append([res[u] for u in uids])
    assert outs[0] == outs[1]


def test_submit_validation():
    cfg, _, _, pp, _, _ = setup("edge-tiny", False)
    eng = pt_engine.ServeEngine(cfg, pp, n_slots=2, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.zeros((8,), np.int32))


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = pt_base.get_smoke_config("edge-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_model.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_model.init_decode_state(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_engine.decode_exec_config(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    pp = pt_model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_engine.ServeEngine(cfg, pp)
