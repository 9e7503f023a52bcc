"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions, so these hold padding,
block clamping, transposed operands and the metadata path against the
Pallas kernels run in interpret mode (as ``tests/test_kernels.py`` runs
them).  Tolerance: both sides accumulate the same float32 products in
another order, so they agree to a few float32 ulps of the result scale —
rtol/atol 1e-5.  ``tests/test_torch_cuda.py`` holds the CUDA kernels
themselves against the plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as ref_sp
from repro.core.scheduler import MatmulSchedule as RefSchedule
from repro.kernels import block_sparse as ref_bs
from repro.kernels import flex_matmul as ref_fm
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.scheduler import MatmulSchedule
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import flex_matmul as pt_fm

TOL = dict(rtol=1e-5, atol=1e-5)


def _sparse(rng, shape, blocks, live):
    k, n = shape
    bk, bn = blocks
    keep = rng.random((-(-k // bk), -(-n // bn))) < live
    mask = np.repeat(np.repeat(keep, bk, 0), bn, 1)[:k, :n]
    return (rng.standard_normal(shape) * mask).astype(np.float32)


@pytest.mark.parametrize("stationarity", ["output", "weight", "input"])
@pytest.mark.parametrize("mnk,blocks", [((4, 96, 64), (4, 32, 16)),
                                        ((40, 72, 56), (16, 32, 16)),
                                        ((8, 256, 128), (8, 128, 64))])
def test_flex_matmul_plain_equals_pallas(stationarity, mnk, blocks):
    m, n, k = mnk
    bm, bn, bk = blocks
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = ref_fm.flex_matmul(
        jnp.asarray(a), jnp.asarray(b),
        schedule=RefSchedule(stationarity, bm, bn, bk), interpret=True)
    ours = pt_fm.flex_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             schedule=MatmulSchedule(stationarity, bm, bn, bk))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # a transposed view of a stored (N, K) matrix gives the same product
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).t()
    ours_t = pt_fm.flex_matmul(torch.from_numpy(a), bt,
                               schedule=MatmulSchedule(stationarity, bm, bn,
                                                       bk))
    np.testing.assert_array_equal(ours_t.numpy(), ours.numpy())


def test_flex_matmul_default_schedule_and_bf16():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 200)).astype(np.float32)
    b = rng.standard_normal((200, 40)).astype(np.float32)
    ref = ref_fm.flex_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    ours = pt_fm.flex_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # bf16 operands: float32 accumulation, one rounding of the result
    ab, bb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    out = pt_fm.flex_matmul(ab, bb)
    assert out.dtype == torch.bfloat16
    exact = torch.matmul(ab.double(), bb.double())
    assert torch.allclose(out.double(), exact, rtol=2 ** -8, atol=1e-2)


def test_flex_matmul_refuses_bad_operands():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="bad operand shapes"):
        pt_fm.flex_matmul(a, torch.zeros((9, 4)))
    with pytest.raises(ValueError, match="operands differ"):
        pt_fm.flex_matmul(a, torch.zeros((8, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown stationarity"):
        pt_fm.flex_matmul(a, torch.zeros((8, 4)),
                          schedule=MatmulSchedule("diagonal", 4, 4, 4))


@pytest.mark.parametrize("a_live,b_live", [(1.0, 0.5), (0.5, 0.5),
                                           (1.0, 0.0)])
@pytest.mark.parametrize("mkn,blocks", [((4, 128, 192), (4, 32, 64)),
                                        ((32, 64, 96), (16, 16, 32))])
def test_block_sparse_plain_equals_pallas(a_live, b_live, mkn, blocks):
    m, k, n = mkn
    bm, bk, bn = blocks
    rng = np.random.default_rng(2)
    a = _sparse(rng, (m, k), (bm, bk), a_live)
    b = _sparse(rng, (k, n), (bk, bn), b_live)
    a_bm, b_bm = ref_sp.block_bitmap(a, bm, bk), ref_sp.block_bitmap(b, bk, bn)
    ref_meta = ref_sp.build_block_sparse_meta_jnp(jnp.asarray(a_bm),
                                                  jnp.asarray(b_bm))
    ref = ref_bs.block_sparse_matmul(jnp.asarray(a), jnp.asarray(b), ref_meta,
                                     interpret=True, out_dtype=jnp.float32)
    meta = pt_sp.build_block_sparse_meta(torch.from_numpy(a_bm),
                                         torch.from_numpy(b_bm))
    ours = pt_bs.block_sparse_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                     meta, out_dtype=torch.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # skipping never approximates: the dense product, to float32 rounding
    np.testing.assert_allclose(ours.numpy(), a @ b, **TOL)


def test_block_sparse_refuses_non_multiples():
    meta = pt_sp.build_block_sparse_meta(torch.ones((1, 2), dtype=torch.bool),
                                         torch.ones((2, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="not block multiples"):
        pt_bs.block_sparse_matmul(torch.zeros((4, 9)), torch.zeros((9, 8)),
                                  meta)
