"""The port's ZVC codec, combined sparsity bitmap, PE-cycle model and plan
estimate against the JAX package's, on the CPU.

Everything here is exact: the codec moves values without arithmetic, so
``packed`` is compared bit for bit (zero signs included; a NaN as a NaN —
XLA on the CPU rewrites a bf16 NaN's payload, the port keeps the input's),
``bitmap`` and ``nnz`` element for element; the byte and cycle models are
copies and are compared as floats, ``site_plan_estimate`` key for key.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import descriptors as ref_desc
from repro.core import sparsity as ref_sp
from repro_torch.configs import base as pt_base
from repro_torch.core import descriptors as pt_desc
from repro_torch.core import sparsity as pt_sp

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tensor(zeros: float, specials: bool, seed: int = 0,
            shape=(37, 53)) -> np.ndarray:
    """float32 values with a share ``zeros`` of exact zeros; ``specials``
    plants ``-0.0``, NaN and ±inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) < zeros] = 0.0
    if specials:
        flat = x.reshape(-1)
        flat[[3, 50, 51]] = -0.0
        flat[[7, 400]] = np.nan
        flat[11], flat[-1] = np.inf, -np.inf
    return x


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or a jax array (float32 or bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return a.view(np.uint16 if a.dtype == np.int16 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _pt_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same_bits(got: torch.Tensor, want) -> None:
    """Bit for bit, a NaN as any NaN."""
    nan = np.isnan(_pt_np(got))
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(want, np.float32)))
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("specials", [False, True], ids=["plain", "special"])
@pytest.mark.parametrize("zeros", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_zvc_codec_equals_reference(dtype, zeros, specials):
    tdt, jdt = DTYPES[dtype]
    x = _tensor(zeros, specials)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(_bits(xt)).view(jdt)           # the same bits
    packed, bitmap, nnz = pt_sp.zvc_encode(xt)
    rp, rb, rn = ref_sp.zvc_encode(xj)
    assert packed.dtype == tdt and packed.shape == (x.size,)
    _same_bits(packed, rp)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(rb))
    assert nnz.dtype == torch.int32 and int(nnz) == int(rn)
    dec = pt_sp.zvc_decode(packed, bitmap)
    assert dec.dtype == tdt and dec.shape == x.shape
    _same_bits(dec, ref_sp.zvc_decode(rp, rb))
    # exact in value: -0.0 comes back as +0.0, NaN stays NaN (its bits too)
    np.testing.assert_array_equal(_pt_np(dec), _pt_np(xt))
    nan = torch.isnan(xt).numpy()
    np.testing.assert_array_equal(_bits(dec)[nan], _bits(xt)[nan])
    assert not np.signbit(_pt_np(dec)[_pt_np(xt) == 0]).any()
    for eb in (1, 2):
        assert pt_sp.zvc_compressed_bytes(xt, eb) == \
            ref_sp.zvc_compressed_bytes(np.asarray(xj), eb)


def test_zvc_keeps_a_last_nonzero():
    """The dump slot is the last one: a tensor whose last element is its
    only non-zero (or all of whose elements are) still packs it."""
    for x in (np.array([0, 0, 0, 5.0], np.float32),
              np.arange(1, 6, dtype=np.float32)):
        packed, bitmap, nnz = pt_sp.zvc_encode(torch.from_numpy(x))
        rp, _, rn = ref_sp.zvc_encode(jnp.asarray(x))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(rp))
        assert int(nnz) == int(rn)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_csb_and_relu_bitmaps_equal_reference(threshold):
    a = _tensor(0.3, True, seed=1)
    w = _tensor(0.6, False, seed=2)
    a_bm = pt_sp.relu_activation_bitmap(torch.from_numpy(a), threshold)
    ra_bm = ref_sp.relu_activation_bitmap(jnp.asarray(a), threshold)
    np.testing.assert_array_equal(a_bm.numpy(), np.asarray(ra_bm))
    w_bm, rw_bm = torch.from_numpy(w != 0), jnp.asarray(w != 0)
    np.testing.assert_array_equal(
        pt_sp.combined_bitmap(a_bm, w_bm).numpy(),
        np.asarray(ref_sp.combined_bitmap(ra_bm, rw_bm)))
    pop = pt_sp.csb_popcount(a_bm, w_bm)
    assert pop.dtype == torch.int32
    assert int(pop) == int(ref_sp.csb_popcount(ra_bm, rw_bm))


@pytest.mark.parametrize("mc", [False, True], ids=["closed", "monte_carlo"])
def test_simulate_pe_cycles_equals_reference(mc):
    for block_macs, n_pes, rounds, dens in ((64, 16, 10, 0.3),
                                            (512, 256, 1000, 0.55),
                                            (8, 2, 3, 1.0), (128, 1, 7, 0.9)):
        for seed in (0, 5):
            kw = dict(macs_per_pe=4, seed=seed, mc=mc)
            assert pt_sp.simulate_pe_cycles(block_macs, n_pes, rounds, dens,
                                            **kw) == \
                ref_sp.simulate_pe_cycles(block_macs, n_pes, rounds, dens,
                                          **kw)


def _ref_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in (("moe", ref_base.MoEConfig), ("ssm", ref_base.SSMConfig),
                      ("rglru", ref_base.RGLRUConfig),
                      ("sparsity", ref_base.SparsityConfig)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ref_base.ArchConfig(**kw)


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("sparsity", [None, (0.5, 0.0), (0.7, 0.05)],
                         ids=["dense", "weight", "two_sided"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-moe-16b",
                                  "gemma-2b"])
def test_site_plan_estimate_equals_reference(arch, sparsity, shards):
    """Every site, the expert branch (deepseek-moe-16b; ``model_shards``
    splits its experts) and a tied head (gemma-2b) included."""
    cfg = pt_base.get_config(arch)
    if sparsity is not None:
        cfg = dataclasses.replace(cfg, sparsity=pt_base.SparsityConfig(
            weight_sparsity=sparsity[0], activation_threshold=sparsity[1]))
    rcfg = _ref_config(cfg)
    shape = pt_base.SHAPES["decode_32k"]
    rshape = ref_base.SHAPES["decode_32k"]
    ns = pt_desc.compile_network_schedule(cfg, shape, model_shards=shards)
    rns = ref_desc.compile_network_schedule(rcfg, rshape,
                                            model_shards=shards)
    assert list(ns.sites) == list(rns.sites)
    for site, d in ns.sites.items():
        for in_bytes in (1, 2):
            got = pt_desc.site_plan_estimate(d, cfg, in_bytes=in_bytes,
                                             model_shards=shards)
            want = ref_desc.site_plan_estimate(rns.sites[site], rcfg,
                                               in_bytes=in_bytes,
                                               model_shards=shards)
            assert got == want, site
    if arch == "deepseek-moe-16b":
        est = pt_desc.site_plan_estimate(ns.sites["moe.experts_in"], cfg,
                                         model_shards=shards)
        assert est["experts"] == -(-cfg.moe.n_experts // shards)
