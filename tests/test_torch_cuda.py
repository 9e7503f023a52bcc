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

The bf16 weight- and input-stationary kernels (tensor cores) are held to
the same tolerance at decode (M = 4, over both their split-K and their
owning grids), at M = 512 and on ragged, unaligned blocks, with B
row-major and read transposed; two runs must agree bit for bit, and the
input-stationary result must equal the weight-stationary one bit for bit.  So are bf16
``fm_output`` and ``bs_matmul`` (one tensor-core template, one launch
plan): at the four decode (K, N), at M 256 and 512, ragged, with bn below
the kernel's 128-column strip, bk 16 and 32, and unaligned row strides;
their bf16 output is the float32 result rounded to nearest even.  Their
K order is fixed by K alone, so ``fm_output`` equals ``bs_matmul`` under
other blocks bit for bit (sparse, all-live, A's rows padded or not), and an
empty list writes zeros.  bf16-activation ``int8_matmul`` and
``block_sparse_matmul(scale=)`` run that template over an int8 payload
widened to bf16 (exact): held to the same tolerance (B = Q·s) at decode,
at M 256 and 8192, on an N that is not a 16-byte row, and bit-equal to
each other under other blocks and with A's rows padded.  The built
libraries' SASS shows tensor-core instructions in the tensor-core kernels
and none in any other kernel (the float32-activation ones stay true
float32).

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

The analytic core (no kernel of its own): the schedule search and the ZVC
codec on the card equal their CPU runs (schedules, energies and cycles
as floats; grid energies bit for bit, cycles within 2⁻⁴⁹; packed bits),
and a planned weight with ``sparse_dispatch=False`` runs ``fm_output``,
bit-equal to the plan's ``bs_matmul``.
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
from repro_torch.kernels import int8_matmul as pt_i8
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


IS_CASES = [  # WS_CASES' shapes under the input-stationary plan: (m, n, k),
    # (bm, bn, bk), workspace cap (None: the wrapper's), split grid expected
    ((4, 5632, 2048), (4, 256, 128), None, True),     # decode mlp.in
    ((4, 5632, 2048), (4, 256, 128), 0, False),
    ((4, 2048, 5632), (4, 256, 128), None, True),     # decode mlp.out
    ((512, 2048, 2048), (128, 128, 128), None, True),
    ((512, 2048, 2048), (128, 128, 128), 0, False),
    ((70, 300, 200), (64, 128, 128), 0, False),       # ragged M and N
    ((6, 36, 70), (6, 36, 35), None, True),           # unaligned K-blocks
    ((6, 36, 70), (6, 36, 35), 0, False),
    ((512, 2048, 2048), (128, 128, 64), 0, False),    # one chunk a K-block
    # two strips a block, old tiles read ahead from rows that are not
    # 16-byte multiples (N 330), a ragged last strip, unaligned A and B
    ((5760, 330, 70), (64, 330, 35), None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mnk,blocks,cap,split", IS_CASES,
                         ids=[f"{c[0]}-{c[1]}-cap{c[2]}" for c in IS_CASES])
def test_cuda_input_stationary_bf16(cuda, monkeypatch, mnk, blocks, cap,
                                    split):
    """The bf16 input-stationary kernel (tensor cores) over its split and
    owning grids: within the tolerance, two runs bit-equal, and equal bit
    for bit to the weight-stationary kernel on the same operands — each
    partial is formed on the same tile from zero and the partials are added
    in K-block order by both."""
    m, n, k = mnk
    if cap is not None:
        monkeypatch.setattr(pt_fm, "WORKSPACE_CAP", cap)
    padded = (-(-x // blk) * blk for x, blk in zip(mnk, blocks))
    plan = pt_fm.input_grid(
        *padded, *blocks,
        torch.cuda.get_device_properties(cuda).multi_processor_count,
        pt_fm.WORKSPACE_CAP)
    assert plan.split == split
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    sched = MatmulSchedule("input", *blocks)
    ws_sched = MatmulSchedule("weight", *blocks)
    before = dict(pt_fm.LAUNCHES)
    for bb in (b, b.t().contiguous().t()):
        out = pt_fm.flex_matmul(a, bb, schedule=sched,
                                out_dtype=torch.float32)
        again = pt_fm.flex_matmul(a, bb, schedule=sched,
                                  out_dtype=torch.float32)
        ws_out = pt_fm.flex_matmul(a, bb, schedule=ws_sched,
                                   out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert torch.equal(out, ws_out)
        assert (out - matmul_ref(a, bb)).abs().max().item() \
            <= _cuda_tol(a, bb)
    assert pt_fm.LAUNCHES["input"] == before["input"] + 4
    # the split grid's second kernel adds the partials
    assert pt_fm.LAUNCHES["input_sum"] == before["input_sum"] + 4 * split


# (m, n, k), blocks (bm, bn, bk): decode (M 4) and prefill-like (M >= 256)
# output-stationary cases, a ragged one, and blocks narrower than the
# kernel's 128-column strip with bk 16 and 32
OS_CASES = [
    *[((4, n, k), (4, 256, 128)) for k, n in DECODE_KN],
    ((512, 2048, 2048), (128, 128, 128)),
    ((256, 5632, 2048), (128, 128, 128)),
    ((70, 300, 200), (64, 128, 128)),
    ((4, 320, 192), (4, 64, 32)),
    ((300, 320, 192), (64, 16, 16)),
    ((16, 176, 96), (8, 16, 32)),
    # row strides that are not 16-byte multiples: copied into zero-padded
    # rows (``aligned_rows``) for TMA and cp.async
    ((6, 36, 70), (6, 36, 35)),
    ((40, 36, 70), (40, 36, 35)),
]


def _bs_operands(a, w, bm, bn, bk):
    """A and B padded to the (bm, bk) x (bk, bn) blocks and their CSB
    metadata, as the planned path builds them."""
    xp = pt_fm.pad_to_blocks(a, bm, bk)
    wp = pt_fm.pad_to_blocks(w, bk, bn)
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(xp, bm, bk),
                                         pt_sp.block_bitmap(wp, bk, bn))
    return xp, wp, meta


def _os_operands(cuda, m, n, k, bn, bk, seed):
    """bf16 A with its second bk-wide K-block and about a third of the
    others zero, and B pruned to half of its (bk, bn) blocks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=cuda)
    dead = torch.rand(-(-k // bk), generator=gen, device=cuda) < 1 / 3
    dead[1:2] = True
    a = a * ~dead.repeat_interleave(bk)[:k]
    b = pt_sp.prune_magnitude(torch.randn((k, n), generator=gen, device=cuda),
                              0.5, (bk, bn))
    return a.bfloat16(), b.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mnk,blocks", OS_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in OS_CASES])
def test_cuda_output_stationary_bf16_matches_plain(cuda, out_dtype, mnk,
                                                   blocks):
    """bf16 ``fm_output`` and ``bs_matmul`` on the tensor cores, B row-major
    and read transposed, within the float32 tolerance of the plain version;
    the bf16 output is the float32 result rounded to nearest even."""
    m, n, k = mnk
    bm, bn, bk = blocks
    sched = MatmulSchedule("output", *blocks)
    a, b = _os_operands(cuda, m, n, k, bn, bk, 10)
    before = dict(pt_fm.LAUNCHES)
    for bb in (b, b.t().contiguous().t()):
        out = pt_fm.flex_matmul(a, bb, schedule=sched, out_dtype=out_dtype)
        xp, wp, meta = _bs_operands(a, bb, bm, bn, bk)
        sparse = pt_bs.block_sparse_matmul(xp, wp, meta,
                                           out_dtype=out_dtype)[:m, :n]
        torch.cuda.synchronize()
        assert out.dtype == sparse.dtype == out_dtype
        assert out.shape == sparse.shape == (m, n)
        if out_dtype is torch.float32:
            plain, tol = matmul_ref(a, bb), _cuda_tol(a, bb)
            assert (out - plain).abs().max().item() <= tol
            assert (sparse - plain).abs().max().item() <= tol
        else:
            exact = pt_fm.flex_matmul(a, bb, schedule=sched,
                                      out_dtype=torch.float32).bfloat16()
            assert torch.equal(out, exact) and torch.equal(sparse, exact)
    plan = pt_fm.output_grid(*(-(-x // blk) * blk
                               for x, blk in zip(mnk, blocks)))
    split = plan.workspace is not None
    assert pt_fm.LAUNCHES["output"] == before["output"] + 2 + (
        2 if out_dtype is torch.bfloat16 else 0)
    assert pt_fm.LAUNCHES["output_sum"] - before["output_sum"] == \
        (pt_fm.LAUNCHES["output"] - before["output"]) * split


@pytest.mark.cuda
@pytest.mark.parametrize("b_trans", [False, True])
@pytest.mark.parametrize("mnk,dense,sparse", [
    *[((4, n, k), (4, 256, 128), (4, 256, 128)) for k, n in DECODE_KN],
    ((4, 2048, 2048), (4, 256, 128), (4, 128, 256)),
    ((4, 2048, 2048), (4, 256, 128), (4, 64, 32)),
    ((512, 2048, 2048), (128, 128, 128), (128, 256, 128)),
    ((512, 2048, 2048), (128, 128, 128), (128, 128, 256)),
    ((300, 320, 200), (128, 128, 128), (64, 16, 16)),
    # the lm_head of a prefill plan: 2 rows padded to its bm of 128
    ((2, 4096, 2048), (128, 256, 128), (128, 128, 128)),
    # K-blocks of 35 straddle the 16-wide groups; unaligned row strides
    ((6, 36, 70), (6, 36, 70), (6, 36, 35)),
    ((40, 36, 70), (40, 36, 70), (40, 36, 35)),
])
def test_cuda_dense_equals_block_sparse_bitwise(cuda, b_trans, mnk, dense,
                                                sparse):
    """One K order whatever the blocks: bf16 ``fm_output`` under the dense
    blocks equals ``bs_matmul`` under other (bm, bn, bk) bit for bit, with
    dead activation K-blocks and pruned weight blocks, all-live or skipped,
    A's rows padded to the blocks or not (``rows``: the plan follows the
    unpadded M); an empty list writes zeros."""
    m, n, k = mnk
    a, b = _os_operands(cuda, m, n, k, sparse[1], sparse[2], 11)
    if b_trans:
        b = b.t().contiguous().t()
    ref = pt_fm.flex_matmul(a, b, schedule=MatmulSchedule("output", *dense),
                            out_dtype=torch.float32)
    xp, wp, meta = _bs_operands(a, b, *sparse)
    assert int(meta.kcnt.sum()) < meta.kcnt.numel() * meta.a_bitmap.shape[1]
    out = pt_bs.block_sparse_matmul(xp, wp, meta, out_dtype=torch.float32,
                                    rows=m)
    live = pt_bs.block_sparse_matmul(xp, wp, _all_live(meta),
                                     out_dtype=torch.float32, rows=m)
    torch.cuda.synchronize()
    assert out.shape == (m, wp.shape[1]) and torch.equal(out, live)
    assert torch.equal(out[:, :n], ref) and not out[:, n:].any()
    padded = pt_bs.block_sparse_matmul(xp, wp, meta, out_dtype=torch.float32)
    assert not padded[m:].any()
    if xp.shape[0] <= 16 or m > 16:       # the same regime: the same bits
        assert torch.equal(padded[:m], out)
    empty = dataclasses.replace(meta, kcnt=torch.zeros_like(meta.kcnt))
    assert not pt_bs.block_sparse_matmul(xp, wp, empty).any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("bn", [128, 64])
def test_cuda_block_sparse_dead_blocks_must_hold_zeros(cuda, m, bn):
    """``bs_matmul`` assumes that a dead pair has an all-zero operand block
    (``core.sparsity`` builds the lists so).  Here K-block 1 of B holds
    data but tile (0, 0)'s list leaves it out.  Where the CSB tiles are
    the kernel's 128 columns (bn 128), the kernel skips it for that tile,
    as the plain version does; where a CTA's columns cover two tiles (bn
    64) and the neighbour lists it, the CTA multiplies it for both, and
    tile (0, 0) gets the dense product: a result that follows the kernel's
    tiling, which is why dead must mean zero."""
    k, n, bk = 512, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    a_bm = torch.ones((1, k // bk), dtype=torch.bool, device=cuda)
    b_bm = torch.ones((k // bk, n // bn), dtype=torch.bool, device=cuda)
    meta = pt_sp.build_block_sparse_meta(a_bm, b_bm)
    kidx, kcnt = meta.kidx.clone(), meta.kcnt.clone()
    kidx[0, 0, :3] = torch.tensor([0, 2, 3], dtype=torch.int32)
    kcnt[0, 0] = 3
    meta = dataclasses.replace(meta, kidx=kidx, kcnt=kcnt)
    out = pt_bs.block_sparse_matmul(a, b, meta, out_dtype=torch.float32)
    dense = matmul_ref(a, b)
    a_skip = a.clone()
    a_skip[:, bk:2 * bk] = 0            # tile (0, 0)'s product without it
    skipped = matmul_ref(a_skip, b)
    torch.cuda.synchronize()
    tol = _cuda_tol(a, b)
    # m rows of 256 are one bm-tile here: tile (0, 0) is columns [0, bn)
    assert (out[:, bn:] - dense[:, bn:]).abs().max().item() <= tol
    assert (skipped[:, :bn] - dense[:, :bn]).abs().max().item() > 100 * tol
    expect = skipped if bn == 128 else dense
    assert (out[:, :bn] - expect[:, :bn]).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("m,rows,seg,split", [
    (4, 128, 0, False), (40, 16, 256, True), (4, 16, 100, True),
    (4, 16, 256, False), (40, 128, 256, False), (40, 128, 0, True)])
def test_cuda_output_kernel_refuses_a_plan_it_does_not_run(cuda, m, rows,
                                                           seg, split):
    """The kernel takes ``output_grid``'s plan and refuses one whose
    regime does not follow M, a segment that is not a multiple of the
    64-wide chunk, or a workspace that does not match the split; the plan
    for M passes."""
    n, k = 256, 512
    a = torch.zeros((m, k), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((k, n), dtype=torch.bfloat16, device=cuda)
    out = torch.empty((m, n), dtype=torch.float32, device=cuda)
    ws = torch.empty((k // 64, m, n), dtype=torch.float32, device=cuda)
    lib = build.library("flex_matmul")

    def launch(rows, seg, split):
        return lib.fm_output(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             ws.data_ptr() if split else None, m, n, k, k, n,
                             m, 128, 128, rows, seg, 0, 1, 0, 1, 0, 0,
                             build.stream_ptr(cuda))

    assert launch(rows, seg, split) != 0
    plan = pt_fm.output_grid(m, n, k)
    assert launch(plan.rows, plan.segment, plan.workspace is not None) == 0
    torch.cuda.synchronize()
    assert not out.any()


def _all_live(meta):
    tk = meta.a_bitmap.shape[1]
    return dataclasses.replace(
        meta, max_nnz=tk, kcnt=torch.full_like(meta.kcnt, tk),
        kidx=torch.arange(tk, dtype=torch.int32, device=meta.kcnt.device)
        .expand(meta.kcnt.shape + (tk,)).contiguous())


TENSOR_CORE_KERNELS = {"flash_attention": ("fa_kernel_mma",),
                       "flex_matmul": ("ws_kernel_mma", "is_kernel_mma",
                                       "os_kernel_mma", "os_wg_kernel_mma"),
                       "block_sparse": ("bs_kernel_mma", "bs_wg_kernel_mma",
                                        "bsq_kernel_mma",
                                        "bsq_wg_kernel_mma"),
                       "int8_matmul": ("i8_kernel_mma", "i8_wg_kernel_mma")}


@pytest.mark.cuda
def test_cuda_tensor_cores_only_in_the_bf16_redesign(cuda):
    """The bf16 flash, weight-, input- and output-stationary and
    block-sparse kernels and the bf16-activation int8 kernels (dense and
    scaled block-sparse) multiply on the tensor cores (SASS HMMA/HGMMA);
    every other kernel — the float32-activation instantiations (float32 and
    int8 B) on ``tile.cuh`` and every segment or K-block sum — has no
    tensor-core instruction."""
    for name in build.SOURCES:
        counts = build.tensor_core_ops(name)
        assert counts, name
        for fn, n_ops in counts.items():
            if "kernel_mma" in fn:
                assert n_ops > 0, fn
            else:
                assert n_ops == 0, fn
        for kernel in TENSOR_CORE_KERNELS.get(name, ()):
            assert any(kernel in fn for fn in counts), (name, kernel)


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
    assert torch.equal(out, pt_bs.block_sparse_matmul(
        a, w, _all_live(meta), out_dtype=torch.float32))
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
    # head dim 256 (gemma-2b, recurrentgemma-9b): q read by wgmma from
    # shared memory, a two-stage ring
    (4, 256, 256, 256, True, 0),
    (4, 256, 256, 256, False, 0),
    (4, 256, 512, 256, True, 128),
    (4, 192, 192, 256, True, 64),   # a last q tile of 64 rows, windowed
]


def _flash_inputs(cuda, bh, sq, skv, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((bh, s, hd), generator=gen, device=cuda)
            for s in (sq, skv, skv))


@pytest.mark.cuda
def test_cuda_flash_hd256_runs_on_the_tensor_cores(cuda):
    """The bf16 flash kernel's head-dim-256 instance (q read by wgmma from
    shared memory) multiplies with HGMMA, as the smaller heads do."""
    counts = build.tensor_core_ops("flash_attention")
    hits = {f: c for f, c in counts.items()
            if "fa_kernel_mma" in f and "ILi256E" in f}
    assert hits and all(c > 0 for c in hits.values()), counts


@pytest.mark.cuda
def test_cuda_flash_backward_refuses_misaligned_rows(cuda):
    """TMA reads 16-byte aligned rows: a contiguous operand whose storage
    offset is not is refused by the wrapper, not read wrongly."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.bfloat16() for t in _flash_inputs(cuda, 2, 128, 128, 64,
                                                    0))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_backward(shifted, k, v, o, lse, o)


@pytest.mark.cuda
def test_cuda_flash_backward_on_wgmma_tma_without_atomics(cuda):
    """The bf16 ``fa_backward`` kernels (dK / dV and dQ passes, hd 64, 128,
    256) multiply with HGMMA only, load their tiles with TMA (UTMALDG),
    hold no atomic instruction and, where this process built them, draw no
    ptxas note that their wgmma pipeline is serialised."""
    faults = build.backward_kernel_faults(
        build.sass_ops("flash_attention"),
        build.BUILD_LOG.get("flash_attention", ""))
    assert len(faults) == 6 and not any(faults.values()), faults


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
    _check_controls(cuda, control, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["p-unrounded", "float64-rounded",
                                     "warp-truncating-p"])
def test_cuda_flash_bf16_check_rejects_controls_hd256(cuda, control):
    """As above at head dim 256, whose bounds carry hd/8 + √hd + 1 score
    roundings per score: the controls still fall outside them."""
    _check_controls(cuda, control, 256)


def _check_controls(cuda, control, hd):
    q, k, v = (x.bfloat16() for x in _flash_inputs(cuda, 8, 512, 512, hd, 7))
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


def _int8_pair_case(cuda, m, k, n, bm, bk, bn, seed):
    """bf16 A (M, K) with about a third of its bk-wide K-blocks zero, a
    weight pruned at (256, 256) and quantized, and the scaled product's
    operands padded to (bm, bk, bn) with their metadata."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=cuda)
    dead = torch.rand(-(-k // bk), generator=gen, device=cuda) < 1 / 3
    a = (a * ~dead.repeat_interleave(bk)[:k]).bfloat16()
    w = pt_sp.prune_magnitude(
        torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5, 0.5,
        (256, 256))
    qw = quantize_weight(w)
    xp = pt_fm.pad_to_blocks(a, bm, bk)
    qp = pt_fm.pad_to_blocks(qw.q, bk, bn)
    sp = pt_fm.pad_to_blocks(qw.scale[None], 1, bn)[0]
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(xp, bm, bk),
                                         pt_sp.block_bitmap(qp, bk, bn))
    return a, qw, xp, qp, sp, meta


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 8192])
def test_cuda_int8_pair_wide_matches_plain(cuda, m):
    """The wgmma regime of both int8 kernels at mlp.in (K 2048, N 5632)
    within the float32 tolerance of their plain versions (B = Q·s), and
    bit-equal to each other."""
    k, n = 2048, 5632
    a, qw, xp, qp, sp, meta = _int8_pair_case(cuda, m, k, n, 128, 128, 256,
                                              13)
    tol = _cuda_tol(a, dequantize_leaf(qw, torch.float32))
    before = dict(pt_bs.LAUNCHES)
    dense = int8_matmul(a, qw, out_dtype=torch.float32)
    sparse = pt_bs.block_sparse_matmul(xp, qp, meta, out_dtype=torch.float32,
                                       scale=sp, rows=m)
    torch.cuda.synchronize()
    assert dense.shape == (m, n) and sparse.shape == (m, qp.shape[1])
    assert (dense - int8_matmul_plain(a, qw.q, qw.scale)).abs().max() \
        .item() <= tol
    assert (sparse - block_sparse_matmul_ref(xp, qp, meta, sp)[:m]).abs() \
        .max().item() <= tol
    assert torch.equal(sparse[:, :n], dense)
    # the wide regime has no split: no segment sum
    assert pt_bs.LAUNCHES["block_sparse_scaled_sum"] == \
        before["block_sparse_scaled_sum"]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bn", [256, 512])
@pytest.mark.parametrize("m,bm", [(4, 4), (256, 128)])
def test_cuda_int8_pair_bitwise_under_other_blocks(cuda, out_dtype, bn, m,
                                                   bm):
    """One K order whatever the blocks: ``int8_matmul`` under its default
    blocks equals ``block_sparse_matmul(scale=)`` under (bm, 128, bn),
    skipped and all-live, bit for bit, and both count their launches (the
    split grid's sum at decode)."""
    k, n = 2048, 5632
    a, qw, xp, qp, sp, meta = _int8_pair_case(cuda, m, k, n, bm, 128, bn, 14)
    assert int(meta.kcnt.sum()) < meta.kcnt.numel() * meta.a_bitmap.shape[1]
    before_i8, before_bs = dict(pt_i8.LAUNCHES), dict(pt_bs.LAUNCHES)
    dense = int8_matmul(a, qw, out_dtype=out_dtype)
    sparse = pt_bs.block_sparse_matmul(xp, qp, meta, out_dtype=out_dtype,
                                       scale=sp, rows=m)
    live = pt_bs.block_sparse_matmul(xp, qp, _all_live(meta),
                                     out_dtype=out_dtype, scale=sp, rows=m)
    torch.cuda.synchronize()
    assert dense.dtype == sparse.dtype == out_dtype
    assert torch.equal(sparse, live) and torch.equal(sparse[:, :n], dense)
    split = m <= 16
    assert pt_i8.LAUNCHES["int8_matmul"] == before_i8["int8_matmul"] + 1
    assert pt_i8.LAUNCHES["int8_matmul_sum"] == \
        before_i8["int8_matmul_sum"] + split
    assert pt_bs.LAUNCHES["block_sparse_scaled"] == \
        before_bs["block_sparse_scaled"] + 2
    assert pt_bs.LAUNCHES["block_sparse_scaled_sum"] == \
        before_bs["block_sparse_scaled_sum"] + 2 * split


@pytest.mark.cuda
def test_cuda_scaled_rows_equals_int8_matmul(cuda):
    """The prefill lm_head's case: 2 rows padded to the plan's bm of 128.
    With ``rows=2`` the scaled kernel plans from the product's own rows
    (mma.sync, as ``int8_matmul`` on the unpadded A) and equals it bit for
    bit; the padded rows are never written."""
    m, k, n = 2, 2048, 4096
    a, qw, xp, qp, sp, meta = _int8_pair_case(cuda, m, k, n, 128, 128, 256,
                                              15)
    out = pt_bs.block_sparse_matmul(xp, qp, meta, out_dtype=torch.float32,
                                    scale=sp, rows=m)
    dense = int8_matmul(a, qw, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and torch.equal(out, dense)
    tol = _cuda_tol(a, dequantize_leaf(qw, torch.float32))
    assert (dense - int8_matmul_plain(a, qw.q, qw.scale)).abs().max() \
        .item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6, 40])
def test_cuda_int8_unaligned_payload_rows(cuda, m):
    """Q (200, 70): its 70-byte rows are not 16-byte multiples, so the
    wrappers copy it into zero-padded rows; both kernels match the plain
    version and each other (blocks (m, 40, 35) for the scaled one)."""
    k, n = 200, 70
    gen = torch.Generator(device=cuda).manual_seed(16)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    qw = quantize_weight(torch.randn((k, n), generator=gen, device=cuda))
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(a, m, 40),
                                         pt_sp.block_bitmap(qw.q, 40, 35))
    tol = _cuda_tol(a, dequantize_leaf(qw, torch.float32))
    dense = int8_matmul(a, qw, out_dtype=torch.float32)
    sparse = pt_bs.block_sparse_matmul(a, qw.q, meta, out_dtype=torch.float32,
                                       scale=qw.scale)
    torch.cuda.synchronize()
    assert (dense - int8_matmul_plain(a, qw.q, qw.scale)).abs().max() \
        .item() <= tol
    assert torch.equal(sparse, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["i8_matmul", "bs_matmul_scaled"])
@pytest.mark.parametrize("m,rows,seg,split", [
    (4, 128, 0, False), (40, 16, 256, True), (4, 16, 256, False),
    (40, 128, 0, True)])
def test_cuda_int8_kernel_refuses_a_plan_it_does_not_run(cuda, kernel, m,
                                                         rows, seg, split):
    """The int8 tensor-core kernels take ``output_grid``'s plan and refuse
    one whose regime does not follow M, or a workspace that does not match
    the split; the plan for M passes and writes the (zero) product."""
    n, k = 256, 512
    a = torch.zeros((m, k), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((k, n), dtype=torch.int8, device=cuda)
    scale = torch.ones((n,), dtype=torch.float32, device=cuda)
    out = torch.full((m, n), 1.0, dtype=torch.float32, device=cuda)
    ws = torch.empty((k // 64, m, n), dtype=torch.float32, device=cuda)
    meta = pt_sp.build_block_sparse_meta(
        torch.ones((1, k // 128), dtype=torch.bool, device=cuda),
        torch.ones((k // 128, n // 128), dtype=torch.bool, device=cuda))
    lib = build.library("int8_matmul" if kernel == "i8_matmul"
                        else "block_sparse")

    def launch(rows, seg, split):
        w = ws.data_ptr() if split else None
        tail = (m, n, k, k, n, m, 128, 128)
        if kernel == "i8_matmul":
            args = (w, *tail, rows, seg)
        else:
            args = (w, meta.kidx.data_ptr(), meta.kcnt.data_ptr(), *tail,
                    meta.max_nnz, rows, seg)
        # bs_matmul_scaled also takes its expert count and strides
        experts = () if kernel == "i8_matmul" else (1, 0, 0, 0, 0)
        return getattr(lib, kernel)(a.data_ptr(), q.data_ptr(),
                                    scale.data_ptr(), out.data_ptr(), *args,
                                    0, 1, 0, *experts, build.stream_ptr(cuda))

    assert launch(rows, seg, split) != 0
    plan = pt_fm.output_grid(m, n, k)
    assert launch(plan.rows, plan.segment, plan.workspace is not None) == 0
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
def test_cuda_sampling_bits_equal_the_cpu(cuda):
    """The port's threefry on the card: keys, random bits and uniforms equal
    the CPU's bit for bit at V = 100352; Gumbel noise (``torch.log`` on
    each device) within one ulp of its magnitude plus 2⁻²³."""
    from repro_torch.models import prng
    v = 100352
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 32 - 1]).repeat_interleave(4)
    pos = torch.tensor([0, 1, 37, 2 ** 20]).repeat(4)
    out = {}
    for dev in ("cpu", cuda):
        key = prng.fold_in(prng.PRNGKey(seeds.to(dev)), pos.to(dev))
        out[str(dev)] = [t.cpu() for t in (
            key, prng.random_bits(key, v),
            prng.uniform(key, v, minval=torch.finfo(torch.float32).tiny),
            prng.gumbel(key, v))]
    (k0, b0, u0, g0), (k1, b1, u1, g1) = out["cpu"], out[str(cuda)]
    assert torch.equal(k0, k1) and torch.equal(b0, b1)
    assert torch.equal(u0.view(torch.int32), u1.view(torch.int32))
    ulp = torch.nextafter(g0.abs(), torch.tensor(float("inf"))) - g0.abs()
    assert torch.isfinite(g1).all()
    assert ((g1 - g0).abs() <= ulp + 2.0 ** -23).all()


@pytest.mark.cuda
def test_cuda_stats_add_no_sync_to_a_decode_block(cuda):
    """A fused decode block that counts activation popcounts (two-sided
    plan, ``collect_stats``) makes no more synchronizing calls than the
    same block without them (``torch.cuda.set_sync_debug_mode``), and
    ``activation_densities`` reads every planned site once."""
    import warnings
    from repro_torch.configs import SparsityConfig, get_smoke_config
    from repro_torch.models import model as pt_model
    from repro_torch.serve import ServeEngine, decode_exec_config
    cfg = get_smoke_config("stablelm-1.6b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = pt_model.init_params(cfg, gen, dtype=torch.bfloat16,
                                  device=cuda)
    params = pt_sp.map_leaves(
        lambda _, leaf: pt_sp.prune_stacked_magnitude(leaf, 0.5, (16, 16)),
        params)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    counts = {}
    for stats in (False, True):
        ec = decode_exec_config(sp_cfg, 4, params=params,
                                collect_stats=stats, device=cuda)
        eng = ServeEngine(cfg, params, n_slots=4, max_seq=32,
                          dtype=torch.bfloat16, exec_cfg=ec,
                          async_dispatch=False, device=cuda)
        for i in range(4):
            eng.submit([3 + i, 5, 7], max_new=12)
        eng.decode_block_step()
        live = eng._live()
        assert len(live) == 4
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng._launch(live, 4)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        eng._account_one()
        counts[stats] = sum("called a synchronizing CUDA operation"
                            in str(w.message) for w in caught)
        if stats:
            dens = eng.activation_densities()
            assert set(dens) == {e.site for e in ec.plan.entries.values()}
            assert all(0.0 < d <= 1.0 for d in dens.values())
    assert counts[True] <= counts[False]


# ---------------------------------------------------------------------------
# plan tiers and self-speculative decoding: StableLM-1.6B's full width at 2
# layers (the plan's blocks (4, 256, 128), which a pruned tier needs on the
# card), weights pruned at (256, 256), weight-only plan at 4 slots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import model as pt_model
    from repro_torch.serve import decode_exec_config
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = pt_sp.map_leaves(
        lambda _, leaf: pt_sp.prune_stacked_magnitude(leaf, 0.5, (256, 256)),
        pt_model.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda"))
    wo_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.0))
    ec = decode_exec_config(wo_cfg, 4, params=params, device="cuda")
    tiers = pt_sp.compile_plan_tiers(params, ec.schedules, (0.0, 0.5))
    return cfg, params, ec, [t.attach(params) for t in tiers]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 20])
def test_cuda_tier_bs_matmul_equals_fm_output_on_the_pruned_weight(
        spec_setup, m):
    """At the six stack sites of layer 0, ``bs_matmul`` under the 0.5
    tier's lists equals ``fm_output`` on the weight ``prune_k_blocks``
    leaves at ``tier_max_live(tk, 0.5)``, bit for bit, at decode's M and a
    verify window's."""
    from repro_torch.kernels.ops import _planned_matmul
    _, params, _, (_, tier) = spec_setup
    gen = torch.Generator(device="cuda").manual_seed(m)
    for parent, leaf in (("attn", "wq"), ("attn", "wkv"), ("attn", "wo"),
                         ("mlp", "w_in"), ("mlp", "w_gate"),
                         ("mlp", "w_out")):
        pw = tier["stack"]["layers"][parent][leaf].index(0)
        assert pw.gather and pw.wgather is None
        w = params["stack"]["layers"][parent][leaf][0]
        k = w.shape[0]
        wp = torch.from_numpy(pt_sp.prune_k_blocks(
            w.float().cpu().numpy(), pw.bk, pw.bn,
            pt_sp.tier_max_live(-(-k // pw.bk), 0.5))).to("cuda",
                                                         torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        got = _planned_matmul(x, pw)
        want = pt_fm.flex_matmul(x, wp, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), pw.site


@pytest.mark.cuda
def test_cuda_verify_window_equals_the_decode_steps(spec_setup):
    """From a state 3 steps deep, each position of a 5-token verify window
    (M = 20 rows at every site) gives ``masked_decode_step``'s logits and
    state bit for bit, and a windowed verify block the sequential one's
    tokens and carries."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as pt_model
    cfg, _, ec, (full, draft) = spec_setup
    b, k = 4, 4
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b,), generator=gen, device="cuda")
    live = torch.ones(b, dtype=torch.bool, device="cuda")
    state = pt_model.init_decode_state(cfg, b, 32, device="cuda")

    def copy():
        return {"layers": {n: t.clone() for n, t in
                           state["layers"].items()}}

    with ops.exec_config(ec), torch.no_grad():
        _, state, toks, pos, _ = pt_model.decode_many(
            full, cfg, toks, state, torch.zeros(b, dtype=torch.long,
                                                device="cuda"), live, 3)
        pos = pos.long()
        win = torch.randint(0, cfg.vocab, (b, k + 1), generator=gen,
                            device="cuda")
        lw, sw = pt_model.verify_window(full, cfg, win, copy(), pos, live)
        ss = copy()
        for i in range(k + 1):
            ls, ss = pt_model.masked_decode_step(full, cfg, win[:, i:i + 1],
                                                 ss, pos + i, live)
            assert torch.equal(_bits(ls[:, 0]), _bits(lw[:, i])), i
        for n in ("k", "v"):
            assert torch.equal(_bits(sw["layers"][n]), _bits(ss["layers"][n]))
        blocks = [pt_model.verify_block(full, draft, cfg, toks, copy(), pos,
                                        live, k, windowed=w)
                  for w in (True, False)]
    for a, c in zip(blocks[0][:1] + blocks[0][2:],
                    blocks[1][:1] + blocks[1][2:]):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_self_draft_engine_accepts_everything(spec_setup):
    """One tier, drafting on the full plan at M = 4 and verifying windows
    at M = 20: every draft is accepted (no EOS; budgets of two windows of
    k + 1), and the streams are the ``step()`` oracle's."""
    from repro_torch.serve import ServeEngine
    cfg, params, ec, _ = spec_setup

    def run(**kw):
        eng = ServeEngine(cfg, params, n_slots=4, max_seq=32,
                          dtype=torch.bfloat16, exec_cfg=ec, decode_block=8,
                          device="cuda", **kw)
        uids = [eng.submit([3 + i, 5, 7], max_new=10) for i in range(4)]
        res = eng.run_until_drained()
        return eng, [res[u] for u in uids]

    eng, out = run(speculate_k=4)
    _, oracle = run(fused=False)
    assert out == oracle
    assert eng.spec_stats["verify_blocks"] > 0
    assert eng.speculative_acceptance() == 1.0


# ---------------------------------------------------------------------------
# the expert axis: one launch over every expert (MoE decode)
# ---------------------------------------------------------------------------

def _expert_case(cuda, k, n, rows, seed, e=64):
    """DeepSeek-MoE-16B's expert shapes: E experts' (K, N) weights pruned at
    (256, 256), and a (E, rows, K) dispatch buffer in which a quarter of
    the experts got no token (zero rows) and the others some zero
    K-blocks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = pt_sp.prune_magnitude(
        torch.randn((e, k, n), generator=gen, device=cuda) * k ** -0.5,
        0.5, (256, 256)).to(torch.bfloat16)
    a = torch.randn((e, rows, k), generator=gen, device=cuda)
    a = a * (torch.rand((e, 1, 1), generator=gen, device=cuda) > 0.25)
    kb = torch.rand((e, 1, k // 128), generator=gen, device=cuda) > 0.3
    return (a * kb.repeat_interleave(128, -1)).to(torch.bfloat16), w


EXPERT_KN = [(2048, 1408), (1408, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("kn", EXPERT_KN, ids=["in", "out"])
def test_cuda_expert_batched_launch_equals_per_expert_launches(cuda, kn,
                                                               rows):
    """``bs_matmul``, ``fm_output`` and ``bs_matmul_scaled`` over the
    expert axis (one launch each) equal E launches of the 2-D kernels bit
    for bit, and their plain versions within the float32 tolerance of each
    expert's operands (B = Q·s for int8)."""
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import (block_sparse_expert_matmul_ref,
                                         expert_matmul_ref, meta_at)
    k, n = kn
    a, w = _expert_case(cuda, k, n, rows, seed=rows + k)
    before = dict(pt_bs.LAUNCHES), dict(pt_fm.LAUNCHES)
    for quant in (False, True):
        wq = quantize_weight(w) if quant else w
        pw = pt_sp.plan_weight(wq, mode="two_sided", bm=rows, bk=128,
                               bn=128 if k == 2048 else 256)
        xp, wp, meta, scale = planned_operands(a, pw)
        out = pt_bs.block_sparse_matmul(xp, wp, meta, scale=scale,
                                        out_dtype=torch.float32)
        for i in range(a.shape[0]):
            one = pt_bs.block_sparse_matmul(
                xp[i], wp[i], meta_at(meta, i), out_dtype=torch.float32,
                scale=None if scale is None else scale[i])
            assert torch.equal(out[i], one), (quant, i)
        plain = block_sparse_expert_matmul_ref(xp, wp, meta, scale)
        dense_w = dequantize_leaf(wq, torch.float32) if quant else w
        for i in range(a.shape[0]):
            tol = _cuda_tol(a[i], dense_w[i])
            assert (out[i] - plain[i]).abs().max().item() <= tol
    sched = MatmulSchedule("output", rows, 128, 128)
    dense = pt_fm.flex_matmul(a, w, schedule=sched, out_dtype=torch.float32)
    for i in range(a.shape[0]):
        assert torch.equal(dense[i], pt_fm.flex_matmul(
            a[i], w[i], schedule=sched, out_dtype=torch.float32))
    # the dense table equals the plan bit for bit (one K order)
    pw = pt_sp.plan_weight(w, mode="two_sided", bm=rows, bk=128, bn=128)
    xp, wp, meta, _ = planned_operands(a, pw)
    assert torch.equal(dense, pt_bs.block_sparse_matmul(
        xp, wp, meta, out_dtype=torch.float32))
    assert torch.allclose(dense, expert_matmul_ref(a, w), rtol=0,
                          atol=max(_cuda_tol(a[i], w[i])
                                   for i in range(a.shape[0])))
    assert pt_bs.LAUNCHES["block_sparse_experts"] \
        > before[0]["block_sparse_experts"]
    assert pt_bs.LAUNCHES["block_sparse_scaled_experts"] \
        > before[0]["block_sparse_scaled_experts"]
    assert pt_fm.LAUNCHES["output_experts"] > before[1]["output_experts"]


@pytest.mark.cuda
def test_cuda_expert_matmul_above_16_rows_loops_the_2d_kernels(cuda):
    """A prefill-sized dispatch buffer (C = 40) takes the 2-D kernels
    expert by expert (the reference's unrolled route), counted as theirs."""
    from repro_torch.kernels.ops import planned_operands
    a, w = _expert_case(cuda, 2048, 1408, 40, seed=3, e=4)
    pw = pt_sp.plan_weight(w, mode="two_sided", bm=40, bk=128, bn=128)
    xp, wp, meta, _ = planned_operands(a, pw)
    n0 = pt_bs.LAUNCHES["block_sparse"]
    out = pt_bs.block_sparse_matmul(xp, wp, meta, out_dtype=torch.float32)
    assert pt_bs.LAUNCHES["block_sparse"] == n0 + 4
    ref = torch.stack([matmul_ref(a[i], w[i]) for i in range(4)])
    for i in range(4):
        assert (out[i] - ref[i]).abs().max().item() <= _cuda_tol(a[i], w[i])


@pytest.mark.cuda
def test_cuda_schedule_search_equals_the_cpu(cuda):
    """The analytic core's search on the card: every yolov2 layer's winning
    schedule, energy and cycles equal to the same search on the CPU, and
    one layer's grid energies bit for bit (cycles within 2⁻⁴⁹: the
    card's libm ``log`` / ``sqrt``)."""
    from repro_torch.configs.cnn_zoo import yolov2
    from repro_torch.core import _vectorized as vec
    from repro_torch.core import scheduler as sch
    from repro_torch.core.energy_model import FLEXNN, SparsityStats
    layers = yolov2()
    sps = [SparsityStats(0.5, 0.3 + 0.02 * i) for i in range(len(layers))]
    got = sch.optimize_network(layers, FLEXNN, sps, device=cuda)
    want = sch.optimize_network(layers, FLEXNN, sps, device="cpu")
    for g, w in zip(got, want):
        assert (g.schedule, g.energy, g.cycles, g.breakdown) == \
            (w.schedule, w.energy, w.cycles, w.breakdown)
    layer, sp = layers[3], sps[3]
    args = (sch._partition_sets(layer, FLEXNN, None),
            sch._pow2_factors(layer.ic, FLEXNN.rf_if),
            sch._pow2_factors(layer.oc, FLEXNN.rf_of),
            sch._pow2_factors(layer.ox, 16), sch._pow2_factors(layer.oy, 16))
    grid = vec._candidate_grid(layer, FLEXNN, *args, sp, cuda)
    cgrid = vec._candidate_grid(layer, FLEXNN, *args, sp,
                                torch.device("cpu"))
    for order in sch._ORDERS:
        e, c = vec.evaluate_grid(layer, FLEXNN, grid, order, sp)
        ce, cc = vec.evaluate_grid(layer, FLEXNN, cgrid, order, sp)
        assert torch.equal(e.cpu(), ce)
        assert ((c.cpu() - cc).abs() <= 2.0 ** -49 * cc.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_zvc_equals_the_cpu(cuda, dtype):
    """The codec on the card: packed bits, bitmap and nnz equal the CPU's,
    decode gives the tensor back, and the CSB popcount agrees."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((512, 1536), generator=gen, device=cuda)
    x = torch.relu(x).to(dtype)
    packed, bitmap, nnz = pt_sp.zvc_encode(x)
    cp, cb, cn = pt_sp.zvc_encode(x.cpu())
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(packed.cpu().view(ints), cp.view(ints))
    assert torch.equal(bitmap.cpu(), cb) and int(nnz) == int(cn)
    assert torch.equal(pt_sp.zvc_decode(packed, bitmap), x)
    w_bm = torch.rand((1536,), generator=gen, device=cuda) < 0.5
    assert int(pt_sp.csb_popcount(bitmap, w_bm)) == \
        int(pt_sp.csb_popcount(cb, w_bm.cpu()))


@pytest.mark.cuda
def test_cuda_sparse_dispatch_off_runs_fm_output(cuda):
    """A planned weight with ``sparse_dispatch=False`` runs ``fm_output``
    at its site's schedule (never ``bs_matmul``), equal bit for bit to the
    plan's block-sparse product (one K order)."""
    from repro_torch.core.descriptors import NetworkSchedule, SiteDescriptor
    from repro_torch.core.flextree import ReduceConfig
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(8)
    k, n = 2048, 5632
    a = torch.randn((4, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = pt_sp.prune_magnitude(
        torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5, 0.5,
        (256, 256)).to(torch.bfloat16)
    pw = pt_sp.plan_weight(w, site="mlp.in", mode="two_sided", bm=4,
                           bk=128, bn=256)
    ns = NetworkSchedule(arch="t", shape="t")
    ns.sites["mlp.in"] = SiteDescriptor(
        site="mlp.in", m=4, n=n, k=k,
        schedule=MatmulSchedule("output", 4, 256, 128,
                                sparsity_mode="two_sided"),
        reduce=ReduceConfig("model", 1), sparsity_mode="two_sided")
    on = ops.ExecConfig(use_kernels=True, schedules=ns)
    with ops.exec_config(on):
        planned = ops.flex_matmul(a, pw, site="mlp.in")
    bs0, os0 = pt_bs.LAUNCHES["block_sparse"], pt_fm.LAUNCHES["output"]
    with ops.exec_config(dataclasses.replace(on, sparse_dispatch=False)):
        off = ops.flex_matmul(a, pw, site="mlp.in")
    torch.cuda.synchronize()
    assert pt_bs.LAUNCHES["block_sparse"] == bs0
    assert pt_fm.LAUNCHES["output"] == os0 + 1
    assert torch.equal(off, planned)


# ---------------------------------------------------------------------------
# gradients: fa_backward and the dense route's autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (512, 512, True, 0), (512, 512, True, 128), (256, 512, True, 0),
    (256, 512, False, 0),
    # the tiling's edges: one 64-row tile; a 128-row block with a ragged
    # half; Sq < Skv by 64; windows of 64 and 100; non-causal
    (64, 64, True, 0), (192, 192, True, 0), (128, 192, True, 0),
    (512, 512, True, 64), (512, 512, True, 100), (192, 192, False, 0)])
def test_cuda_flash_backward_against_plain(cuda, hd, sq, skv, causal,
                                           window):
    """``fa_backward``: float32 within four times the float32 plain
    version's own error against float64; bf16 under
    ``ref.flash_backward_check``, which truncated P and dS fail; two runs
    bit-equal; O with lse equal to O without."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (flash_attention_backward_plain,
                                         flash_backward_check)
    gen = torch.Generator(device=cuda).manual_seed(hd + sq + window)
    kw = dict(causal=causal, window=window)
    q = torch.randn((4, sq, hd), generator=gen, device=cuda)
    k, v = (torch.randn((4, skv, hd), generator=gen, device=cuda)
            for _ in range(2))
    do = torch.randn((4, sq, hd), generator=gen, device=cuda)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    exact = flash_attention_backward_plain(
        *(t.double() for t in (q, k, v, o, lse, do)), **kw)
    plain = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    for a, p, e in zip(got, plain, exact):
        tol = 4 * (p.double() - e).abs().max().item() \
            + 2.0 ** -24 * e.abs().max().item()
        assert (a.double() - e).abs().max().item() <= tol
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob, lseb = fa.flash_attention(qb, kb, vb, return_lse=True, **kw)
    assert torch.equal(ob, fa.flash_attention(qb, kb, vb, **kw))
    gb = fa.flash_attention_backward(qb, kb, vb, ob, lseb, dob, **kw)
    again = fa.flash_attention_backward(qb, kb, vb, ob, lseb, dob, **kw)
    assert all(torch.equal(a, b) for a, b in zip(gb, again))
    pb = flash_attention_backward_plain(qb, kb, vb, ob, lseb, dob, **kw)
    w = flash_attention_backward_plain(qb, kb, vb, ob, lseb, dob,
                                       magnitudes=True, **kw)
    assert all(flash_backward_check(a, p, m).ok()
               for a, p, m in zip(gb, pb, w))
    tr = flash_attention_backward_plain(qb, kb, vb, ob, lseb, dob,
                                        truncate=True, **kw)
    assert not all(flash_backward_check(a, p, m).ok()
                   for a, p, m in zip(tr, pb, w))


@pytest.mark.cuda
@pytest.mark.parametrize("stationarity", ["output", "weight", "input"])
@pytest.mark.parametrize("k,n", [(2048, 5632), (5632, 2048)])
def test_cuda_matmul_function_grads(cuda, stationarity, k, n):
    """The dense route under autograd at M = 512: dX and dW through the
    kernels against autograd of the plain float32 product, within
    √K·2⁻²⁴·max(|A|@|B|) of each backward product."""
    from repro_torch.kernels.ops import _DenseMatmul
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((512, k), generator=gen, device=cuda).requires_grad_()
    w = (torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5
         ).requires_grad_()
    g = torch.randn((512, n), generator=gen, device=cuda)
    sched = MatmulSchedule(stationarity, 128, 128, 128)
    before = dict(pt_fm.LAUNCHES)
    _DenseMatmul.apply(x, w, sched, True, None).backward(g)
    assert sum(pt_fm.LAUNCHES.values()) > sum(before.values())
    xp, wp = (t.detach().clone().requires_grad_() for t in (x, w))
    torch.matmul(xp, wp).backward(g)
    assert (x.grad - xp.grad).abs().max().item() <= _cuda_tol(g, w.t())
    assert (w.grad - wp.grad).abs().max().item() <= _cuda_tol(
        x.detach().t(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 16, 961])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_expert_function_grads(cuda, c, dtype):
    """The expert route under autograd at DeepSeek-MoE-16B's experts_in
    shape (E 64 there; 4 experts here at C 961, the training capacity of
    2 x 4096 tokens): dX and dW through ``fm_output`` over E against
    autograd of the plain batched float32 product, float32 within
    √K·2⁻²⁴·max(|A|@|B|) of each expert's backward product, bf16 within it
    plus one bf16 step; at C ≤ 16 dX is one launch over the experts (Wᵀ
    read in place) and equals per-expert launches bit for bit."""
    from repro_torch.kernels import ops
    e = 64 if c <= 16 else 4
    k, n = 2048, 1408
    gen = torch.Generator(device=cuda).manual_seed(c)
    x0 = torch.randn((e, c, k), generator=gen, device=cuda)
    w0 = torch.randn((e, k, n), generator=gen, device=cuda) * k ** -0.5
    g = torch.randn((e, c, n), generator=gen, device=cuda).to(dtype)
    x, w = (t.to(dtype).requires_grad_() for t in (x0, w0))
    ec = ops.ExecConfig(use_kernels=True)
    before = dict(pt_fm.LAUNCHES)
    with ops.exec_config(ec):
        out = ops.flex_expert_matmul(x, w, site="moe.experts_in")
    out.backward(g)
    key = "output_experts" if c <= 16 and dtype == torch.bfloat16 \
        else "output"
    assert pt_fm.LAUNCHES[key] > before[key]
    xp, wp = (t.detach().clone().requires_grad_() for t in (x, w))
    torch.matmul(xp.float(), wp.float()).to(dtype).backward(g)
    for got, want, (a, b) in ((x.grad, xp.grad, (g, w.detach().transpose(
            -1, -2))), (w.grad, wp.grad, (x.detach().transpose(-1, -2), g))):
        for i in range(e):
            tol = _cuda_tol(a[i], b[i])
            err = (got[i].float() - want[i].float()).abs()
            if dtype == torch.bfloat16:
                tol = tol + 2.0 ** -7 * torch.maximum(
                    got[i].float().abs(), want[i].float().abs())
            assert bool((err <= tol).all()), i
    if c <= 16 and dtype == torch.bfloat16:
        wt = w.detach().transpose(-1, -2)
        batched = pt_fm.flex_matmul(g, wt, out_dtype=torch.float32)
        for i in range(e):
            assert torch.equal(batched[i], pt_fm.flex_matmul(
                g[i], wt[i], out_dtype=torch.float32))



# ---------------------------------------------------------------------------
# the serve executables: every model call of the engine a CUDA-graph replay
# (StableLM-1.6B's full width at 2 layers, ``spec_setup``'s weight-only plan
# and tiers)
# ---------------------------------------------------------------------------

def _exec_engine(spec_setup, **kw):
    from repro_torch.serve import ServeEngine
    cfg, params, ec, _ = spec_setup
    kw.setdefault("exec_cfg", ec)
    return ServeEngine(cfg, params, n_slots=4, max_seq=64,
                       dtype=torch.bfloat16, decode_block=8,
                       async_dispatch=False, device="cuda", **kw)


def _state_copy(state):
    return pt_sp.map_leaves(lambda _, t: t.clone(), state)


def _same_state(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for (_, x), (_, y) in
               zip(pt_sp.iter_leaves(a), pt_sp.iter_leaves(b)))


def _launch_delta(before, after):
    return {m: {k: n - before[m].get(k, 0) for k, n in c.items()
                if n != before[m].get(k, 0)} for m, c in after.items()}


@pytest.mark.cuda
def test_cuda_replayed_entry_points_equal_eager(spec_setup):
    """Mid-traffic, a replayed ``decode_many`` block and a replayed greedy
    verify block equal the eager functions on a copy of the state bit for
    bit (tokens, carries, every state leaf), and each replay credits the
    kernels' ``LAUNCHES`` exactly as the eager call counts them; a 13-token
    prompt feed, padded and split into two replays of 8 positions, leaves
    the state of one unpadded eager ``prefill_into_slot`` bit for bit."""
    from repro_torch.models import model as pt_model
    from repro_torch.serve.executables import launch_counts
    cfg = spec_setup[0]
    eng = _exec_engine(spec_setup, plan_tiers=(0.0, 0.5), speculate_k=4)
    for i in range(3):
        eng.submit([3 + i, 5, 7, 9], max_new=32)
    eng.decode_block_step()
    live = eng._live()
    assert len(live) == 3
    args = (eng._to_device(eng._current_tokens(live)),
            eng._to_device(eng._slot_positions()), eng._live_mask(live),
            eng._to_device(eng._slot_budgets(live)))
    full, draft = eng._tier_params[0], eng._tier_params[-1]
    common = dict(rem=args[3], eos_id=None, nan_guard=True)
    for ex, eager in (
            (eng._block_exec(0, 8, False),
             lambda st: pt_model.decode_many(full, cfg, args[0], st, args[1],
                                             args[2], 8, **common)),
            (eng._block_exec(0, 5, False, spec_k=4),
             lambda st: pt_model.verify_block(full, draft, cfg, args[0], st,
                                              args[1], args[2], 4,
                                              windowed=True, **common))):
        eng._run(ex, *eng._dead_rows(False))          # capture, dead rows
        assert ex.graph is not None
        copy = _state_copy(eng.state)
        c0 = launch_counts()
        got = eng._run(ex, *args)
        c1 = launch_counts()
        with eng._scope():
            block, st, *carries = eager(copy)
        c2 = launch_counts()
        torch.cuda.synchronize()
        for a, b in zip(got, (block, *carries)):
            assert torch.equal(a, b), ex
        assert _same_state(eng.state, st), ex
        assert _launch_delta(c0, c1) == _launch_delta(c1, c2), ex
        assert _launch_delta(c0, c1)["repro_torch.kernels.block_sparse"]
    eng.submit(list(range(10, 24)), max_new=4)
    copy = _state_copy(eng.state)
    slot_pos = eng._to_device(eng._slot_positions())
    eng._admit()
    assert eng.slots[3].prefill_cursor == 13
    assert eng._executables[("feed", 8)].replays == 2
    with eng._scope():
        pt_model.prefill_into_slot(full, cfg, list(range(10, 23)),
                                   [True] * 13, 3, copy, slot_pos, 0, True)
    torch.cuda.synchronize()
    assert _same_state(eng.state, copy)


@pytest.mark.cuda
def test_cuda_planted_sync_raises_at_capture(spec_setup, monkeypatch):
    """An entry point that reads a value back to the host (a planted
    ``.item()``) cannot be captured: the engine raises ``CaptureError``
    naming it, and does not run it eagerly; the card serves on after."""
    from repro_torch.models import model as pt_model
    from repro_torch.serve.executables import CaptureError
    eng = _exec_engine(spec_setup)
    real = pt_model.decode_many

    def planted(*a, **kw):
        out = real(*a, **kw)
        out[0].sum().item()
        return out
    monkeypatch.setattr(pt_model, "decode_many", planted)
    with pytest.raises(CaptureError, match="decode_many"):
        eng._run(eng._block_exec(0, 2, False), *eng._dead_rows(False))
    monkeypatch.undo()
    # the failed capture left the allocator out of capture: a freed GiB is
    # released by empty_cache (while a capture counts as underway, it
    # releases nothing)
    torch.cuda.empty_cache()
    x = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    held = torch.cuda.memory_reserved()
    del x
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held
    fresh = _exec_engine(spec_setup)
    uid = fresh.submit([3, 5, 7], max_new=4)
    assert len(fresh.run_until_drained()[uid]) == 4


@pytest.mark.cuda
def test_cuda_recapture_after_recalibration(spec_setup):
    """``maybe_recalibrate`` with a changed table drops every captured
    graph; the entry points are captured again under the new table and
    serve the same streams."""
    from repro_torch.configs import SparsityConfig
    from repro_torch.serve import decode_exec_config
    cfg, params, _, _ = spec_setup
    ts_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    ec = decode_exec_config(ts_cfg, 4, params=params, collect_stats=True,
                            device="cuda")
    eng = _exec_engine(spec_setup, exec_cfg=ec)
    prompts = [[3 + i, 5, 7, 9] for i in range(3)]
    uids = [eng.submit(p, max_new=6) for p in prompts]
    first = eng.run_until_drained()
    old = list(eng._executables.values())
    assert old and all(ex.graph is not None for ex in old)
    assert eng.maybe_recalibrate(drift_threshold=-1.0) is not None
    assert not eng._executables
    again = [eng.submit(p, max_new=6) for p in prompts]
    res = eng.run_until_drained()
    assert [res[u] for u in again] == [first[u] for u in uids]
    new = list(eng._executables.values())
    assert new and all(ex.graph is not None and ex.replays for ex in new)
    assert not any(ex in old for ex in new)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_cuda_replayed_block_makes_no_synchronizing_call(spec_setup, stats):
    """Launching a decode block from the carries, once its graph is
    captured, and reading it makes no synchronizing call
    (``torch.cuda.set_sync_debug_mode``), popcounts on or off."""
    import warnings
    from repro_torch.configs import SparsityConfig
    from repro_torch.serve import decode_exec_config
    cfg, params, _, _ = spec_setup
    ts_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    ec = decode_exec_config(ts_cfg, 4, params=params, collect_stats=stats,
                            device="cuda")
    eng = _exec_engine(spec_setup, exec_cfg=ec)
    for i in range(4):
        eng.submit([3 + i, 5, 7], max_new=24)
    eng.decode_block_step()
    eng.decode_block_step()
    live = eng._live()
    assert len(live) == 4 and eng._carry is not None
    assert eng._executables[("decode_many", 0, 8, False)].replays == 2
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._launch(live, 8)
            eng._account_one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one warning a process says the debug mode is a prototype: count the
    # synchronizing calls' own
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs


# ---------------------------------------------------------------------------
# the last two configs and the serving CLI on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_mrope_decode_block_replays_without_a_sync(cuda):
    """Qwen2-VL's smoke config (M-RoPE) under a two-sided plan: a decode
    block, once captured, replays from the carries and is read with no
    synchronizing call (the rotary frequencies and the three streams are
    built on the card)."""
    import warnings
    from repro_torch.configs import SparsityConfig, get_smoke_config
    from repro_torch.models import model as pt_model
    from repro_torch.serve import ServeEngine, decode_exec_config
    cfg = get_smoke_config("qwen2-vl-72b")
    assert cfg.rope == "mrope"
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = pt_sp.map_leaves(
        lambda _, leaf: pt_sp.prune_stacked_magnitude(leaf, 0.5, (16, 16)),
        pt_model.init_params(cfg, gen, dtype=torch.bfloat16, device=cuda))
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    ec = decode_exec_config(sp_cfg, 4, params=params, use_kernels=True,
                            device=cuda)
    eng = ServeEngine(cfg, params, n_slots=4, max_seq=64,
                      dtype=torch.bfloat16, exec_cfg=ec, decode_block=8,
                      async_dispatch=False, device=cuda)
    for i in range(4):
        eng.submit([3 + i, 5, 7], max_new=24)
    eng.decode_block_step()
    eng.decode_block_step()
    live = eng._live()
    assert len(live) == 4 and eng._carry is not None
    assert eng._executables[("decode_many", 0, 8, False)].replays == 2
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng._launch(live, 8)
            eng._account_one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["mlp.in", "mlp.out"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_qwen2_vl_ragged_sites_match_plain(cuda, site, dtype):
    """Qwen2-VL-72B's layer-0 MLP sites at decode (M 4): d_ff 29568 is
    115.5 blocks of 256, so mlp.in's last N-block and mlp.out's last
    K-block are ragged (the plan's zero-padded ``wpad``).  ``bs_matmul``
    on the pruned plan against its plain version and its all-live run,
    ``fm_output`` under the dense table's schedule against ``matmul_ref``
    (``_cuda_tol``), and in bf16 the two bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.serve import decode_exec_config
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=1)
    k, n = ((cfg.d_model, cfg.d_ff) if site == "mlp.in"
            else (cfg.d_ff, cfg.d_model))
    assert (k if site == "mlp.out" else n) % 256 == 128
    gen = torch.Generator(device=cuda).manual_seed(24)
    w = pt_sp.prune_magnitude(
        torch.randn((k, n), generator=gen, device=cuda) * 0.02, 0.5,
        (256, 256)).to(dtype)
    pw = pt_sp.plan_weight(w, site=site, mode="two_sided", bm=16, bk=256,
                           bn=256)
    assert pw.wpad is not None
    a = torch.randn((4, k), generator=gen, device=cuda).to(dtype)
    xp, wp, meta, _ = planned_operands(a, pw)
    out = pt_bs.block_sparse_matmul(xp, wp, meta, out_dtype=torch.float32,
                                    rows=4)
    tol = _cuda_tol(a, w)
    plain = block_sparse_matmul_ref(xp, wp, meta)[:4]
    assert (out - plain).abs().max() <= tol
    assert torch.equal(out, pt_bs.block_sparse_matmul(
        xp, wp, _all_live(meta), out_dtype=torch.float32, rows=4))
    sched = decode_exec_config(cfg, 4, use_kernels=True, device=cuda) \
        .schedules.sites[site].schedule
    dense = pt_fm.flex_matmul(a, w, schedule=sched, out_dtype=torch.float32)
    assert (dense - matmul_ref(a, w)).abs().max() <= tol
    if dtype is torch.bfloat16:          # one K order fixed by K alone
        assert torch.equal(dense, out[:, :n])


@pytest.mark.cuda
def test_cuda_serve_cli_launches_fm_output(cuda, capsys):
    """``launch.serve.main`` on the card serves every request through the
    dense table's kernels: ``fm_output`` launches, bf16 weights."""
    from repro_torch.launch import serve
    before = pt_fm.LAUNCHES["output"]
    res = serve.main(["--arch", "stablelm-1.6b", "--smoke", "--requests",
                      "3", "--max-new", "4", "--device", "cuda"])
    assert sorted(res) == [1, 2, 3] and all(len(t) == 4
                                            for t in res.values())
    assert pt_fm.LAUNCHES["output"] > before
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
