"""Every leaf of the reference's parameter tree crosses into the port bit
for bit (bf16 included), and the port's own init draws the reference's
tree layout, shapes, dtypes and distributions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro_torch.configs import base as pt_base
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparsity import iter_leaves
from repro_torch.models import model as pt_model

ARCHS = ["edge-tiny", "stablelm-1.6b", "yi-9b", "gemma-2b",
         "chatglm3-6b", "qwen2-vl-72b", "llama4-scout-17b-a16e"]


def ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_params_round_trip_bit_exact(arch, dtype):
    cfg = pt_base.get_smoke_config(arch)
    ref = jax.tree.map(np.asarray, ref_model.init_params(
        ref_config(cfg), jax.random.PRNGKey(0), dtype=dtype))
    ours = params_from_numpy(ref, device="cpu")
    ref_leaves = dict(iter_leaves(ref))
    our_leaves = dict(iter_leaves(ours))
    assert sorted(our_leaves) == sorted(ref_leaves)
    for path, leaf in our_leaves.items():
        r = ref_leaves[path]
        assert tuple(leaf.shape) == r.shape, path
        if r.dtype.name == "bfloat16":
            assert leaf.dtype == torch.bfloat16, path
            back = leaf.view(torch.int16).numpy()
        else:
            assert str(leaf.dtype) == f"torch.{r.dtype.name}", path
            back = leaf.numpy()
        np.testing.assert_array_equal(back, _bits(r), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_layout(arch):
    cfg = pt_base.get_smoke_config(arch)
    ref = ref_model.init_params(ref_config(cfg), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    ours = pt_model.init_params(cfg, gen, device="cpu")
    ref_leaves = dict(iter_leaves(jax.tree.map(np.asarray, ref)))
    our_leaves = dict(iter_leaves(ours))
    assert sorted(our_leaves) == sorted(ref_leaves)
    for path, leaf in our_leaves.items():
        r = ref_leaves[path]
        assert tuple(leaf.shape) == r.shape, path
        assert str(leaf.dtype).split(".")[1] == r.dtype.name, path
        # same distribution: norms exact, weights' spread within 25%
        if r.ndim == 1 or path[-1] in ("scale", "bias"):
            np.testing.assert_array_equal(leaf.numpy(), r)
        else:
            ours_sd = float(leaf.float().std())
            ref_sd = float(np.asarray(r, np.float32).std())
            assert abs(ours_sd / ref_sd - 1) < 0.25, path
    again = pt_model.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    for path, leaf in iter_leaves(again):
        assert torch.equal(leaf, our_leaves[path]), path
