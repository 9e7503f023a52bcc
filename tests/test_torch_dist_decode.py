"""The sharded decode step of every family, on 4 gloo ranks, against the
JAX package's unsharded ``decode_step``.

The ranks run ``torch_dist_ranks.decode_rank`` (no JAX there): the smoke
config of each architecture, float32, from the same weights and the same
filled decode state (every leaf drawn from a seed: KV caches, a Whisper
memory, SSM and RG-LRU states), 3 steps of ``serve.engine
.build_serve_step`` with every row at its own position under decode rules
on meshes (2, 2) and (1, 4), the caches' rows cut over ``model`` (SP) or
not, and the FSDP of the cells (Qwen2-VL and Llama-4 decode with it).
gemma-2b's single kv head is not split; Whisper at 6 heads does not
split over 4 model ranks and runs whole on each; recurrentgemma-9b's rolling
window (32 rows) has wrapped at the positions decoded; Qwen2-VL rotates
with M-RoPE.  This process runs the reference's steps meanwhile.  Every
step's logits and the state gathered after the last step must equal the
reference's within ``test_torch_dist_families.py``'s float32 tolerance:
1e-5 of the largest magnitude.

A mesh of one rank (in this process) runs the unsharded arithmetic: the
serve step under its rules equals the port's unsharded ``decode_step``
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_to_numpy
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as pt_model
from repro_torch.serve.engine import build_serve_step
from repro_torch.sharding import partition
from repro_torch.train.train_step import param_specs

ARCHS = ("stablelm-1.6b", "gemma-2b", "deepseek-moe-16b",
         "llama4-scout-17b-a16e", "mamba2-1.3b", "recurrentgemma-9b",
         "whisper-tiny", "qwen2-vl-72b")
# whisper-tiny with 6 heads: over 4 model ranks they do not split, and
# every rank runs every head (self- and cross-attention)
OVER = {"whisper-tiny-h6": ("whisper-tiny", dict(n_heads=6, n_kv_heads=6))}
MESHES = ((2, 2), (1, 4))
B, STEPS = 4, 3
MAX_SEQ = {"recurrentgemma-9b": 96}        # a window of 32 rows, wrapped


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(base, arch):
    cfg = base.get_smoke_config(OVER.get(arch, (arch,))[0])
    return dataclasses.replace(cfg, **OVER[arch][1]) if arch in OVER else cfg


def _case(arch, seed):
    cfg = _config(pt_base, arch)
    p = pt_model.init_params(cfg, torch.Generator().manual_seed(seed),
                             dtype=torch.float32, device="cpu")
    s = MAX_SEQ.get(arch, 32)
    rng = np.random.default_rng(seed)
    state = params_to_numpy(pt_model.init_decode_state(
        cfg, B, s, torch.float32, device="cpu"))

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        return rng.standard_normal(tree.shape).astype(np.float32)
    return {"arch": OVER.get(arch, (arch,))[0], "cfg": cfg,
            "params": params_to_numpy(p),
            "state": fill(state),
            "tokens": rng.integers(0, cfg.vocab, (STEPS, B, 1)
                                   ).astype(np.int64),
            # every row at its own position, the last step inside the cache
            "pos": np.array([s // 2 + 3 * r for r in range(B)]) - 4}


def _reference(case):
    cfg = _config(ref_base, case["key"])
    step = jax.jit(lambda p, t, st, pos: ref_model.decode_step(
        p, cfg, t, st, pos))
    p = jax.tree.map(jnp.asarray, case["params"])
    st = jax.tree.map(jnp.asarray, case["state"])
    logits = []
    for t in range(STEPS):
        lg, st = step(p, jnp.asarray(case["tokens"][t], jnp.int32), st,
                      jnp.asarray(case["pos"] + t, jnp.int32))
        logits.append(np.asarray(lg))
    return {"logits": logits, "state": jax.tree.map(np.asarray, st)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_decode"))
    cases = {a: {**_case(a, i), "key": a}
             for i, a in enumerate(ARCHS + tuple(OVER))}
    ctx = ranks.spawn(ranks.decode_rank, 4, d,
                      {"cases": cases, "meshes": MESHES})
    try:
        ref = {a: _reference(c) for a, c in cases.items()}
    finally:
        out = ranks.collect(ctx, d, timeout=200.0)
    return cases, ref, out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _close(port, ref, what):
    p = port.detach().double().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float64)
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, what
    err = np.abs(p - r).max()
    assert err <= 1e-5 * np.abs(r).max() + 1e-7, (what, err)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("seq_shard", [False, True], ids=["tp", "sp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS + tuple(OVER))
def test_sharded_decode_matches_the_reference(run, arch, mesh, seq_shard):
    _, ref, out = run
    got = out[(arch, mesh, seq_shard)]
    want = ref[arch]
    # SP cuts the caches' rows over the model axis, else nothing cuts them
    assert got["cache"] == ("model" if seq_shard else None) or \
        arch == "mamba2-1.3b" and got["cache"] is None
    for t in range(STEPS):
        _close(got["logits"][t], want["logits"][t], f"logits step {t}")
    for path, w in _paths(want["state"]).items():
        g = got["state"]
        for k in path.split("/"):
            g = g[k]
        _close(g, w, path)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(run, arch):
    cases, _, _ = run
    case = cases[arch]
    cfg = case["cfg"]
    mesh = Mesh((1, 1), ("data", "model"))
    rules = partition.make_rules(mesh, kind="decode", n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads, seq_shard=True)
    specs = param_specs(cfg, rules)
    p = {k: v for k, v in ranks._params(case["params"]).items()}
    serve = build_serve_step(cfg)
    st_a = ranks._params(case["state"])
    st_b = ranks._params(case["state"])
    for t in range(STEPS):
        tok = torch.from_numpy(case["tokens"][t])
        pos = torch.from_numpy(case["pos"] + t)
        with partition.use_rules(rules, specs, "data", "model"):
            lg_a, st_a = serve(p, tok, st_a, pos)
        lg_b, st_b = pt_model.decode_step(p, cfg, tok, st_b, pos)
        assert torch.equal(lg_a, lg_b)
    for path, a in _paths(st_a).items():
        b = st_b
        for k in path.split("/"):
            b = b[k]
        assert torch.equal(a, b), path
