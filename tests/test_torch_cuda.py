"""The CUDA kernels against their plain PyTorch versions, on a card.

These import no JAX, so they run on the GPU machine as they are
(``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q``); without
a CUDA device each test skips.  Shapes: every (K, N) of StableLM-1.6B's
decode sites at M = 4 (attn.q/attn.out 2048×2048, attn.kv 2048×4096,
mlp.in/gate 2048×5632, mlp.out 5632×2048; the int8 kernels also the
2048×100352 lm_head), and a ragged shape.
Tolerance: √K·2⁻²⁴·max(|A|@|B|) — two float32 sums of the same products in
different orders differ by roundings of random sign, growing like √K —
which float32 operands cut to TF32's 10-bit mantissa exceed (checked); with
an int8 B, B is its dequantized value Q·s.  The block-sparse runs must
equal their all-live runs bit for bit, and the two int8 kernels each other.

The bf16 weight-stationary kernel (tensor cores) is held to the same
tolerance at decode (M = 4, over both its split-K and its owning grid),
at M = 512 and on ragged, unaligned blocks, with B row-major and read
transposed, and two runs must agree bit for bit.  The built libraries'
SASS shows tensor-core instructions in the bf16 tensor-core kernels and
none in any other kernel (the float32 ones stay true float32).

The flash-attention kernel: in float32 against the dense reference in
float64 under ``_flash_tol`` (derived there), which operands cut to TF32
exceed on a causal case (checked); in bf16 against its plain version in
the kernel's order under the tensor-core tolerance ``ref.flash_tc_check``
(derived there): the bf16 kernel sums its scores on the tensor cores, so
a p within the score error of a bf16 rounding boundary may round one step
apart; each element is bounded by one bf16 ulp of itself, float32 floors
and 2⁻⁷ times the weight of such fragile p, and the share of differing
elements by twice the share in which a model of the tensor cores'
summation differs.  p kept in float32 before PV, the exact softmax
rounded to bf16 and p truncated in one warp's rows fail it (checked).
"""
import dataclasses

import pytest
import torch

from repro_torch.core import sparsity as pt_sp
from repro_torch.core.scheduler import MatmulSchedule
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import build
from repro_torch.kernels import flex_matmul as pt_fm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                     flash_attention_flip_bounds,
                                     flash_attention_plain,
                                     flash_attention_ref, flash_tc_check,
                                     int8_matmul_plain, matmul_ref)
from repro_torch.quant.quantize import dequantize_leaf, quantize_weight

DECODE_KN = [(2048, 2048), (2048, 4096), (2048, 5632), (5632, 2048)]
INT8_KN = DECODE_KN + [(2048, 100352)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _cuda_tol(a, b):
    k = a.shape[1]
    return k ** 0.5 * 2.0 ** -24 * torch.matmul(a.abs().float(),
                                                b.abs().float()).max().item()


def _tf32(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _int8_case(cuda, dtype, k, n, seed):
    """A (4, K) activation with two dead K-blocks and a weight pruned at
    (256, 256), quantized; the plan's (4, 128, 256) metadata."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((4, k), generator=gen, device=cuda)
    a[:, 256:512] = 0
    w = pt_sp.prune_magnitude(
        torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5, 0.5,
        (256, 256))
    qw = quantize_weight(w)
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(a, 4, 128),
                                         pt_sp.block_bitmap(qw.q, 128, 256))
    return a.to(dtype), qw, meta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stationarity", ["output", "weight", "input"])
@pytest.mark.parametrize("mnk,blocks", [
    *[((4, n, k), (4, 256, 128)) for k, n in DECODE_KN],
    ((70, 300, 200), (64, 128, 128))])
def test_cuda_flex_matmul_matches_plain(cuda, dtype, stationarity, mnk,
                                        blocks):
    m, n, k = mnk
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    sched = MatmulSchedule(stationarity, *blocks)
    for bb in (b, b.t().contiguous().t()):
        out = pt_fm.flex_matmul(a, bb, schedule=sched,
                                out_dtype=torch.float32)
        err = (out - matmul_ref(a, bb)).abs().max().item()
        assert err <= _cuda_tol(a, bb)


WS_CASES = [  # (m, n, k), (bm, bn, bk), workspace cap (None: the
    # wrapper's), split grid expected
    ((4, 5632, 2048), (4, 256, 128), None, True),     # decode mlp.in
    ((4, 5632, 2048), (4, 256, 128), 0, False),
    ((4, 2048, 5632), (4, 256, 128), None, True),     # decode mlp.out
    ((512, 2048, 2048), (128, 128, 128), None, True),
    ((512, 2048, 2048), (128, 128, 128), 0, False),
    ((70, 300, 200), (64, 128, 128), 0, False),       # ragged M and N
    ((6, 36, 70), (6, 36, 35), None, True),           # unaligned K-blocks
    ((6, 36, 70), (6, 36, 35), 0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mnk,blocks,cap,split", WS_CASES,
                         ids=[f"{c[0]}-{c[1]}-cap{c[2]}" for c in WS_CASES])
def test_cuda_weight_stationary_bf16(cuda, monkeypatch, mnk, blocks, cap,
                                     split):
    m, n, k = mnk
    if cap is not None:
        monkeypatch.setattr(pt_fm, "WORKSPACE_CAP", cap)
    padded = (-(-x // blk) * blk for x, blk in zip(mnk, blocks))
    plan = pt_fm.weight_grid(
        *padded, *blocks,
        torch.cuda.get_device_properties(cuda).multi_processor_count,
        pt_fm.WORKSPACE_CAP)
    assert plan.split == split
    gen = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    sched = MatmulSchedule("weight", *blocks)
    before = dict(pt_fm.LAUNCHES)
    for bb in (b, b.t().contiguous().t()):
        out = pt_fm.flex_matmul(a, bb, schedule=sched,
                                out_dtype=torch.float32)
        again = pt_fm.flex_matmul(a, bb, schedule=sched,
                                  out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert (out - matmul_ref(a, bb)).abs().max().item() \
            <= _cuda_tol(a, bb)
    assert pt_fm.LAUNCHES["weight"] == before["weight"] + 4
    # the split grid's second kernel adds the partials
    assert pt_fm.LAUNCHES["weight_sum"] == before["weight_sum"] + 4 * split


@pytest.mark.cuda
def test_cuda_tensor_cores_only_in_the_bf16_redesign(cuda):
    """The bf16 flash and weight-stationary kernels multiply on the tensor
    cores (SASS HMMA/HGMMA); every other kernel — the float32
    instantiations among them — has no tensor-core instruction."""
    for name in build.SOURCES:
        counts = build.tensor_core_ops(name)
        assert counts, name
        for fn, n_ops in counts.items():
            if "kernel_mma" in fn:
                assert n_ops > 0, fn
            else:
                assert n_ops == 0, fn
    names = [fn for name in ("flash_attention", "flex_matmul")
             for fn in build.tensor_core_ops(name) if "kernel_mma" in fn]
    assert any("fa_kernel_mma" in fn for fn in names)
    assert any("ws_kernel_mma" in fn for fn in names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", DECODE_KN)
def test_cuda_block_sparse_matches_plain_and_all_live(cuda, dtype, k, n):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((4, k), generator=gen, device=cuda)
    a[:, 256:512] = 0                       # two dead activation K-blocks
    a = a.to(dtype)
    w = pt_sp.prune_magnitude(
        torch.randn((k, n), generator=gen, device=cuda).to(dtype), 0.5,
        (256, 256))
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(a, 4, 128),
                                         pt_sp.block_bitmap(w, 128, 256))
    out = pt_bs.block_sparse_matmul(a, w, meta, out_dtype=torch.float32)
    err = (out - block_sparse_matmul_ref(a, w, meta)).abs().max().item()
    assert err <= _cuda_tol(a, w)
    tk = k // 128
    live = dataclasses.replace(
        meta, max_nnz=tk, kcnt=torch.full_like(meta.kcnt, tk),
        kidx=torch.arange(tk, dtype=torch.int32, device=cuda)
        .expand(meta.kcnt.shape + (tk,)).contiguous())
    assert torch.equal(out, pt_bs.block_sparse_matmul(
        a, w, live, out_dtype=torch.float32))
    # an empty tile list writes zeros
    empty = dataclasses.replace(meta, kcnt=torch.zeros_like(meta.kcnt))
    assert not pt_bs.block_sparse_matmul(a, w, empty).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", DECODE_KN)
def test_cuda_tolerance_rejects_tf32_operands(cuda, k, n):
    """The float32 tolerance has the power to tell true float32 from TF32:
    the same product on operands cut to TF32 falls outside it."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((4, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda)
    err = (matmul_ref(_tf32(a), _tf32(b)) - matmul_ref(a, b)).abs().max()
    assert err.item() > _cuda_tol(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", INT8_KN)
def test_cuda_int8_kernels_match_plain_all_live_and_each_other(cuda, dtype, k,
                                                               n):
    a, qw, meta = _int8_case(cuda, dtype, k, n, 3)
    tol = _cuda_tol(a, dequantize_leaf(qw, torch.float32))
    out = pt_bs.block_sparse_matmul(a, qw.q, meta, out_dtype=torch.float32,
                                    scale=qw.scale)
    plain = block_sparse_matmul_ref(a, qw.q, meta, qw.scale)
    assert (out - plain).abs().max().item() <= tol
    tk = k // 128
    live = dataclasses.replace(
        meta, max_nnz=tk, kcnt=torch.full_like(meta.kcnt, tk),
        kidx=torch.arange(tk, dtype=torch.int32, device=cuda)
        .expand(meta.kcnt.shape + (tk,)).contiguous())
    assert torch.equal(out, pt_bs.block_sparse_matmul(
        a, qw.q, live, out_dtype=torch.float32, scale=qw.scale))
    dense = int8_matmul(a, qw, out_dtype=torch.float32)
    assert (dense - int8_matmul_plain(a, qw.q, qw.scale)).abs().max() \
        .item() <= tol
    # one summation order (K ascending) whatever the blocks: the dense
    # kernel at (4, 128, 128) equals the block-sparse one at (4, 128, 256)
    assert torch.equal(dense, out)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_sparse_scaled", "int8_matmul"])
@pytest.mark.parametrize("k,n", INT8_KN)
def test_cuda_int8_tolerance_rejects_tf32_operands(cuda, kernel, k, n):
    """The int8 payload is exact in TF32, so the control cuts A: the plain
    version on a TF32 activation falls outside the float32 tolerance."""
    a, qw, meta = _int8_case(cuda, torch.float32, k, n, 4)
    tol = _cuda_tol(a, dequantize_leaf(qw, torch.float32))
    if kernel == "int8_matmul":
        def plain(x):
            return int8_matmul_plain(x, qw.q, qw.scale)
    else:
        def plain(x):
            return block_sparse_matmul_ref(x, qw.q, meta, qw.scale)
    assert (plain(_tf32(a)) - plain(a)).abs().max().item() > tol


def _flash_tol(q, k, v):
    """Float32 flash attention against the exact (float64) softmax.  With
    ε = 2⁻²⁴ and S = hd^-0.5·max(|q|@|k|ᵀ) (a bound on |score|): each score
    errs by ≤ √hd·ε·S (random-sign sums, as in the matmul tolerance) + ε·S
    (the scaling); a weight p = exp(s - m) then errs relatively by twice that
    plus ε·2S (the subtraction) + ε (expf); the rescales add 2ε per kv block
    and the sums √Skv·ε; an output o = Σ w·v moves by at most 2·max|v| times
    the weights' relative error.  So ε·max|v|·(4(√hd + 2)S + 2·n_blocks +
    2√Skv + 2)."""
    hd, skv = q.shape[2], k.shape[1]
    s_max = hd ** -0.5 * max(
        torch.matmul(q[i:i + 1].abs().double(),
                     k[i:i + 1].abs().double().transpose(1, 2)).max().item()
        for i in range(q.shape[0]))
    n_blocks = skv // 64
    return 2.0 ** -24 * v.abs().max().item() * (
        4 * (hd ** 0.5 + 2) * s_max + 2 * n_blocks + 2 * skv ** 0.5 + 2)


FLASH_CASES = [  # (bh, sq, skv, hd, causal, window)
    (8, 512, 512, 64, True, 0),
    (8, 512, 512, 64, False, 0),
    (8, 512, 512, 64, True, 128),
    (8, 128, 512, 64, True, 0),
    (4, 256, 256, 128, True, 0),
    (4, 256, 256, 32, True, 64),
    (4, 256, 256, 32, False, 0),
    (4, 192, 192, 64, True, 0),     # a last q tile of 64 rows
    (4, 192, 512, 128, True, 128),
]


def _flash_inputs(cuda, bh, sq, skv, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((bh, s, hd), generator=gen, device=cuda)
            for s in (sq, skv, skv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-"
                              f"{'causal' if c[4] else 'full'}-w{c[5]}"
                              for c in FLASH_CASES])
def test_cuda_flash_attention_matches_plain(cuda, dtype, case):
    bh, sq, skv, hd, causal, window = case
    q, k, v = (x.to(dtype) for x in _flash_inputs(cuda, bh, sq, skv, hd, 5))
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    if dtype is torch.float32:
        exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                    causal=causal, window=window)
        err = (out.double() - exact).abs().max().item()
        assert err <= _flash_tol(q, k, v)
    else:
        kw = dict(causal=causal, window=window)
        plain = flash_attention_plain(q, k, v, **kw)
        assert flash_tc_check(out, plain, v,
                              flash_attention_flip_bounds(q, k, v, **kw)).ok


@pytest.mark.cuda
def test_cuda_flash_tolerance_rejects_tf32_operands(cuda):
    """On a causal case (rows with few keys carry v almost unaveraged), the
    exact softmax of operands cut to TF32 falls outside ``_flash_tol``."""
    q, k, v = _flash_inputs(cuda, 8, 512, 512, 64, 6)
    exact = flash_attention_ref(q.double(), k.double(), v.double())
    cut = flash_attention_ref(*(_tf32(x).double() for x in (q, k, v)))
    assert (cut - exact).abs().max().item() > _flash_tol(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["p-unrounded", "float64-rounded",
                                     "warp-truncating-p"])
def test_cuda_flash_bf16_check_rejects_controls(cuda, control):
    """The tensor-core tolerance rejects p kept in float32 before PV (v
    widened exactly), the exact softmax rounded to bf16, and p rounded
    toward zero in one 16-row slice of each 128 q rows (one faulty
    consumer warp); the kernel itself passes it."""
    q, k, v = (x.bfloat16() for x in _flash_inputs(cuda, 8, 512, 512, 64, 7))
    plain = flash_attention_plain(q, k, v)
    if control == "p-unrounded":
        other = flash_attention_plain(q, k, v.float())
    elif control == "float64-rounded":
        other = flash_attention_ref(q.double(), k.double(),
                                    v.double()).bfloat16()
    else:
        warp = (torch.arange(q.shape[1], device=cuda) % 128 < 16)
        other = torch.where(warp[None, :, None], flash_attention_plain(
            q, k, v, truncate_p=True), plain)
    bounds = flash_attention_flip_bounds(q, k, v)
    assert not flash_tc_check(other, plain, v, bounds).ok
    assert flash_tc_check(flash_attention(q, k, v), plain, v, bounds).ok
