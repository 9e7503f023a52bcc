"""The port's checkpoints against the reference's ``checkpoint/ckpt.py``:
the same files, and round trips both ways for params plus ``OptState``
with ZVC at rest on and off; ``latest_step``, keep-k and the atomic
``.tmp`` rename.  Everything restored is compared bit for bit.

One direction is narrower for bf16 leaves: the reference's own restore
of a bf16 ``.npy`` (its numpy writes ``<V2``) raises "No cast function
available" in this environment's numpy / ml_dtypes, so port → reference
runs on float32 trees, and for bf16 the port's files are held equal to
the reference's byte for byte instead.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import ckpt as pt_ckpt
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.sparsity import zvc_decode_np, zvc_encode_np
from repro.core import sparsity as ref_sp
from repro_torch.train import optimizer as pt_opt


def _params(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(2, 8, 6)).astype(np.float32)
    w[:, :, :3] = 0.0                                   # 50 % zeros: ZVC
    return {"embed": rng.normal(size=(16, 6)).astype(np.float32),
            "stack": {"layers": {"w": w,
                                 "scale": np.ones((2, 6), np.float32)}},
            "final_norm": {"bias": np.zeros((6,), np.float32)}}


def _ref_state(dtype=jnp.float32, seed=0):
    p = jax.tree.map(lambda x: jnp.asarray(x, dtype), _params(seed=seed))
    st = ref_opt.init_opt_state(p)
    st = st._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda x: x.astype(jnp.float32) * 0.5,
                                     p),
                     nu=jax.tree.map(lambda x: jnp.square(
                         x.astype(jnp.float32)), p))
    return {"params": p, "opt": st}


def _port_state(ref):
    return {"params": params_from_numpy(jax.tree.map(np.asarray,
                                                     ref["params"]),
                                        device="cpu"),
            "opt": opt_state_from_numpy(jax.tree.map(np.asarray,
                                                     ref["opt"]),
                                        device="cpu")}


def _same_as_ref(port, ref):
    """Every leaf of a port state bit-equal to the reference state's."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    pflat = pt_ckpt._leaf_paths(port)
    assert len(flat) == len(pflat)
    for kp, leaf in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        got = pflat[path]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), path
        else:
            assert np.array_equal(got.numpy(), want), path
            assert str(got.numpy().dtype) == str(want.dtype), path


def test_leaf_paths_match_the_reference():
    ref = _ref_state()
    assert list(pt_ckpt._leaf_paths(_port_state(ref))) == \
        list(ref_ckpt._leaf_paths(ref))
    assert "opt/.mu/stack/layers/w" in pt_ckpt._leaf_paths(_port_state(ref))


@pytest.mark.parametrize("zvc", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, zvc):
    for dtype in (jnp.float32, jnp.bfloat16):
        d = str(tmp_path / str(jnp.dtype(dtype)))
        ref = _ref_state(dtype)
        ref_ckpt.save(d, 7, ref, extra={"step": 7, "data": {"step": 3}},
                      zvc=zvc)
        like = _port_state(_ref_state(dtype, seed=1))
        state, extra = pt_ckpt.restore(d, like)
        assert extra == {"step": 7, "data": {"step": 3}}
        assert isinstance(state["opt"], pt_opt.OptState)
        _same_as_ref(state, ref)


@pytest.mark.parametrize("zvc", [False, True])
def test_port_checkpoint_restores_in_reference(tmp_path, zvc):
    ref = _ref_state()
    pt_ckpt.save(str(tmp_path), 7, _port_state(ref), extra={"step": 7},
                 zvc=zvc)
    state, extra = ref_ckpt.restore(str(tmp_path), _ref_state(seed=1))
    assert extra == {"step": 7}
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(ref)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert a.dtype == b.dtype


@pytest.mark.parametrize("zvc", [False, True])
def test_port_files_equal_the_reference_files(tmp_path, zvc):
    """bf16 params and float32 moments: the manifest and every array file
    hold what the reference writes (the .npy bytes themselves; an .npz's
    members as arrays, since the zip records its own write time)."""
    ref = _ref_state(jnp.bfloat16)
    ref_ckpt.save(str(tmp_path / "ref"), 7, ref, extra={"step": 7}, zvc=zvc)
    pt_ckpt.save(str(tmp_path / "pt"), 7, _port_state(ref),
                 extra={"step": 7}, zvc=zvc)
    rd, pd = (str(tmp_path / s / "step_000000007") for s in ("ref", "pt"))
    with open(os.path.join(rd, "MANIFEST.json")) as f:
        rm = f.read()
    with open(os.path.join(pd, "MANIFEST.json")) as f:
        assert f.read() == rm
    names = sorted(os.listdir(os.path.join(rd, "arrays")))
    assert names == sorted(os.listdir(os.path.join(pd, "arrays")))
    assert any(n.endswith(".zvc.npz") for n in names) == zvc
    for n in names:
        a, b = (os.path.join(x, "arrays", n) for x in (rd, pd))
        if n.endswith(".npy"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n
        else:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za) == sorted(zb)
                for k in za:
                    assert za[k].tobytes() == zb[k].tobytes(), (n, k)
    assert json.loads(rm)["index"]["params/embed"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("zvc", [False, True])
def test_port_round_trip_bf16(tmp_path, zvc):
    ref = _ref_state(jnp.bfloat16)
    port = _port_state(ref)
    pt_ckpt.save(str(tmp_path), 3, port, extra={"step": 3}, zvc=zvc)
    state, _ = pt_ckpt.restore(str(tmp_path), _port_state(_ref_state(
        jnp.bfloat16, seed=2)))
    _same_as_ref(state, ref)


def test_negative_zero_follows_the_reference(tmp_path):
    """ZVC counts -0.0 as zero on both sides, so it restores as 0.0."""
    x = np.zeros((8,), np.float32)
    x[0], x[1] = -0.0, 2.0
    ref = {"w": jnp.asarray(x)}
    ref_ckpt.save(str(tmp_path / "r"), 1, ref, zvc=True)
    pt_ckpt.save(str(tmp_path / "p"), 1, {"w": torch.from_numpy(x)},
                 zvc=True)
    r, _ = ref_ckpt.restore(str(tmp_path / "p"), ref)
    p, _ = pt_ckpt.restore(str(tmp_path / "r"), {"w": torch.zeros(8)})
    assert np.array_equal(np.asarray(r["w"]).view(np.int32),
                          p["w"].numpy().view(np.int32))


def test_latest_step_keep_k_and_atomic_rename(tmp_path):
    d = str(tmp_path)
    assert pt_ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        pt_ckpt.restore(d, {"w": torch.zeros(2)})
    for step in (1, 2, 3, 4):
        final = pt_ckpt.save(d, step, {"w": torch.full((2,), float(step))},
                             keep=2)
        assert final.endswith(f"step_{step:09d}")
    assert pt_ckpt.all_steps(d) == [3, 4] == ref_ckpt.all_steps(d)
    # a crashed writer's .tmp directory is invisible, and replaced later
    os.makedirs(os.path.join(d, "step_000000009.tmp", "arrays"))
    assert pt_ckpt.latest_step(d) == 4 == ref_ckpt.latest_step(d)
    pt_ckpt.save(d, 9, {"w": torch.ones(2)}, keep=2)
    assert not os.path.exists(os.path.join(d, "step_000000009.tmp"))
    assert pt_ckpt.all_steps(d) == [4, 9]
    state, _ = pt_ckpt.restore(d, {"w": torch.zeros(2)}, step=4)
    assert torch.equal(state["w"], torch.full((2,), 4.0))


def test_host_zvc_codec_equals_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[rng.random((5, 7)) < 0.6] = 0.0
    pv, pb = zvc_encode_np(x)
    rv, rb = ref_sp.zvc_encode_np(x)
    assert np.array_equal(pv, rv) and np.array_equal(pb, rb)
    assert np.array_equal(zvc_decode_np(pv, pb), x)
    assert pt_sp.zvc_decode_np is zvc_decode_np


def test_trainer_state_round_trips_on_the_port(tmp_path):
    """A port OptState of bf16 params through save / restore into a
    differently valued template: every leaf, dtypes kept."""
    params = {"w": torch.randn(4, 3).bfloat16(), "b": torch.randn(3)}
    st = pt_opt.init_opt_state(params)
    st = st._replace(step=torch.tensor(5, dtype=torch.int32))
    pt_ckpt.save(str(tmp_path), 5, {"params": params, "opt": st})
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": pt_opt.init_opt_state(params)}
    state, _ = pt_ckpt.restore(str(tmp_path), like)
    assert int(state["opt"].step) == 5
    assert state["opt"].step.dtype == torch.int32
    for k in params:
        assert torch.equal(state["params"][k], params[k])
    np_state = opt_state_to_numpy(state["opt"])
    assert int(np_state[0]) == 5
    assert params_to_numpy(state["params"])["w"].dtype == np.float32
