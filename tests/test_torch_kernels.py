"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions, so these hold padding,
block clamping, transposed operands and the metadata path against the
Pallas kernels run in interpret mode (as ``tests/test_kernels.py`` runs
them).  Tolerance: both sides accumulate the same float32 products in
another order, so they agree to a few float32 ulps of the result scale —
rtol/atol 1e-5.  ``tests/test_torch_cuda.py`` holds the CUDA kernels
themselves against the plain versions on a card.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as ref_sp
from repro.core.scheduler import MatmulSchedule as RefSchedule
from repro.kernels import block_sparse as ref_bs
from repro.kernels import flex_matmul as ref_fm
from repro_torch.core import sparsity as pt_sp
from repro_torch.core.scheduler import H100, MatmulSchedule
from repro_torch.kernels import block_sparse as pt_bs
from repro_torch.kernels import flex_matmul as pt_fm
from repro_torch.kernels import ref as pt_ref

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
                                        ((8, 256, 128), (8, 128, 64)),
                                        # decode depth: M = 4, 16 K-blocks
                                        ((4, 128, 256), (4, 32, 16))])
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


def test_weight_grid_spreads_decode_over_the_card():
    """Decode mlp.in (M 4, K 2048, N 5632 at blocks (4, 256, 128)) has one
    M-tile, so the owning grid would give 44 blocks; the K-blocks run in
    parallel instead, at least one block per SM, over a workspace far under
    the cap."""
    plan = pt_fm.weight_grid(4, 5632, 2048, 4, 256, 128, 132)
    assert plan.split and plan.rows == 16
    assert plan.grid == (44, 16) and plan.grid[0] * plan.grid[1] >= 132
    assert plan.workspace == (16, 4, 5632)
    assert 4 * 16 * 4 * 5632 < pt_fm.WORKSPACE_CAP
    # without room for the workspace, or with one K-block, it owns
    assert not pt_fm.weight_grid(4, 5632, 2048, 4, 256, 128, 132, 0).split
    assert not pt_fm.weight_grid(4, 5632, 128, 4, 256, 128, 132).split


def test_weight_grid_owns_at_prefill():
    """At M = 8192 the partials would take 2.95 GB: the owning grid, 44
    strips x 6 M-tile groups of 64 rows (about two blocks per SM)."""
    plan = pt_fm.weight_grid(8192, 5632, 2048, 128, 128, 128, 132)
    assert not plan.split and plan.workspace is None
    assert plan.grid == (44, 6) and plan.rows == 64
    # the lm_head at decode has strips enough: it owns, one group
    head = pt_fm.weight_grid(4, 100352, 2048, 4, 256, 128, 132)
    assert not head.split and head.grid == (784, 1)


@pytest.mark.parametrize("args,match", [
    ((4, 5632, 2048, 4, 256, 100), "not multiples"),
    ((6, 5632, 2048, 4, 256, 128), "not multiples"),
    ((4, 5632, 2048, 0, 256, 128), "non-positive"),
    ((4, 128, 1024, 4, 128, 1024), "shared memory"),
])
def test_weight_grid_refuses_what_it_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        pt_fm.weight_grid(*args, 132)


def test_input_grid_splits_at_decode():
    """Decode mlp.in (M 4, K 2048, N 5632 at blocks (4, 256, 128)) has one
    M-tile, so the owning grid would give 44 blocks; one block per
    (K-block, strip group) instead — 16 x 16, each holding its K-block of
    A over about three strips — over a workspace far under the cap."""
    plan = pt_fm.input_grid(4, 5632, 2048, 4, 256, 128, 132)
    assert plan.split and plan.rows == 16
    assert plan.grid == (16, 16) and plan.grid[0] * plan.grid[1] >= 132
    assert plan.workspace == (16, 4, 5632)
    assert 4 * 16 * 4 * 5632 < pt_fm.WORKSPACE_CAP
    # without room for the workspace, or with one K-block, it owns: one
    # M-tile, a block per strip
    owns = pt_fm.input_grid(4, 5632, 2048, 4, 256, 128, 132, 0)
    assert not owns.split and owns.grid == (1, 44) and owns.workspace is None
    assert not pt_fm.input_grid(4, 5632, 128, 4, 256, 128, 132).split


def test_input_grid_owns_at_prefill():
    """At M = 8192 the partials would take 2.95 GB: the owning grid, 128
    M-tiles of 64 rows x 2 groups of 22 strips (about two blocks per SM)."""
    plan = pt_fm.input_grid(8192, 5632, 2048, 128, 128, 128, 132)
    assert not plan.split and plan.workspace is None
    assert plan.grid == (128, 2) and plan.rows == 64
    # the lm_head at decode has strips enough: it owns, 264 strip groups
    head = pt_fm.input_grid(4, 100352, 2048, 4, 256, 128, 132)
    assert not head.split and head.grid == (1, 264) and head.rows == 16


@pytest.mark.parametrize("args,match", [
    ((4, 5632, 2048, 4, 256, 100), "not multiples"),
    ((6, 5632, 2048, 4, 256, 128), "not multiples"),
    ((4, 5632, 2048, 0, 256, 128), "non-positive"),
    ((4, 5632, 2048, 4, 256, -128), "non-positive"),
    ((4, 128, 4096, 4, 128, 4096), "shared memory"),
    ((128, 128, 512, 128, 128, 512), "shared memory"),
])
def test_input_grid_refuses_what_it_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        pt_fm.input_grid(*args, 132)


def test_input_grid_takes_a_k_block_weight_grid_refuses():
    """B streams past the resident A in 64-deep chunks, so a 1024-deep
    K-block that ``weight_grid`` cannot hold as a B tile fits at 16 rows."""
    args = (4, 128, 1024, 4, 128, 1024, 132)
    with pytest.raises(ValueError, match="shared memory"):
        pt_fm.weight_grid(*args)
    plan = pt_fm.input_grid(*args)
    assert plan.rows == 16 and plan.grid == (1, 1) and not plan.split


@pytest.mark.parametrize("mnk,blocks", [
    ((4, 5632, 2048), (4, 256, 128)), ((4, 2048, 5632), (4, 256, 128)),
    ((4, 100352, 2048), (4, 256, 128)), ((16, 128, 256), (16, 128, 128)),
    ((8192, 5632, 2048), (128, 128, 128)), ((512, 2048, 2048),
                                            (128, 128, 128)),
    ((128, 384, 256), (64, 128, 128)), ((6, 36, 70), (6, 36, 35))])
def test_input_grid_tiles_rows_as_weight_grid(mnk, blocks):
    """The two revisit kernels form each partial on a tile of the same
    height (16 rows up to M = 16, 64 above) and split K the same way, the
    precondition of their bitwise equality; each plan's workspace, when it
    splits, is the (tk, M, N) partials of that K split."""
    wg = pt_fm.weight_grid(*mnk, *blocks, 132)
    ig = pt_fm.input_grid(*mnk, *blocks, 132)
    assert ig.rows == wg.rows
    m, n, k = mnk
    tk = k // blocks[2]
    for plan in (wg, ig):
        assert plan.workspace == ((tk, m, n) if plan.split else None)
    if ig.split:                     # a block per (K-block, strip group)
        assert ig.grid[0] == tk and 1 <= ig.grid[1] <= -(-n // 128)
    else:                            # a block per (M-tile, strip group)
        assert ig.grid[0] == -(-m // ig.rows)


_CSRC = pathlib.Path(pt_fm.__file__).parent / "csrc"


def _cuh_constants():
    """The integer ``constexpr`` constants of tile.cuh and mma.cuh."""
    consts = {}
    for name in ("tile.cuh", "mma.cuh"):
        text = (_CSRC / name).read_text()
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                    re.M):
            consts[key] = eval(expr, {}, dict(consts))
    return consts


def test_revisit_layout_constants_match_mma_cuh():
    """``input_grid`` / ``weight_grid`` size shared memory with the
    kernels' own constants, so a plan they admit is one the launcher takes."""
    c = _cuh_constants()
    assert (pt_fm.WS_STRIP, pt_fm.WS_CHUNK) == (c["kTN"], c["kKC"])
    assert (pt_fm.IS_RING, pt_fm.IS_OUT_TILES, pt_fm.IS_OUT_LD) == (
        c["kRing"], c["kOutTiles"], c["kOutLd"])
    assert H100.vmem_bytes == c["kSmemLimit"]


@pytest.mark.parametrize("fn", ["ws_smem_bytes", "is_smem_bytes"])
def test_revisit_smem_bytes_match_mma_cuh(fn):
    """The Python shared-memory size equals mma.cuh's function of the same
    name, its body read as Python, for both tile heights and split grids."""
    text = (_CSRC / "mma.cuh").read_text()
    params, body = re.search(fn + r"\(([^)]*)\) \{(.*?)\n\}", text,
                             re.S).groups()
    for c_text, py in (("const int ", ""), ("(size_t)", ""), ("/", "//"),
                       ("sizeof(bf16)", "2"), ("sizeof(float)", "4"),
                       ("split ? 0 :", "0 if split else"),
                       ("return ", "out = ")):
        body = body.replace(c_text, py)
    code = "\n".join(" ".join(st.split()) for st in body.split(";")
                      if st.strip())
    for rows in (16, 64):
        for bk in (35, 64, 128, 200, 256, 1024):
            for split in (0, 1):
                env = dict(_cuh_constants(), tmr=rows, bk=bk, split=split)
                exec(code, {}, env)
                args = (rows, bk) + ((bool(split),) if "split" in params
                                     else ())
                assert getattr(pt_fm, fn)(*args) == env["out"], (rows, bk)


@pytest.mark.parametrize("m,n,k", [(4, 5632, 2048), (4, 2048, 5632),
                                   (4, 100352, 2048), (16, 36, 70),
                                   (8192, 5632, 2048), (70, 384, 256)])
def test_output_grid_is_the_same_whatever_the_blocks(m, n, k):
    """``fm_output`` and ``bs_matmul`` share one plan: it is a function of
    (M, N, K) alone (it takes no blocks), so any two block choices that pad
    the operands to the same shape get the same regime and segments;
    the regime follows M (16 rows and K segments of 256 up to M = 16, one
    128-row tile and all of K above)."""
    plan = pt_fm.output_grid(m, n, k)
    assert plan == pt_fm.output_grid(m, n, k)
    skinny = m <= 16
    assert plan.rows == (16 if skinny else 128)
    assert plan.segment == (256 if skinny else 0)
    segments = -(-k // 256) if skinny else 1
    assert plan.workspace == ((segments, m, n) if segments > 1 else None)


@pytest.mark.parametrize("k", [16, 70, 256, 257, 2048, 5632])
def test_output_grid_segments_tile_k_in_multiples_of_16(k):
    """The segments the kernel takes — CTA z of a strip sums K from
    z·segment, for as many CTAs as the workspace has partials — start at
    multiples of 16 (and of 64, the staged chunk), have one constant length
    whatever K, and cover [0, K) in ascending order."""
    plan = pt_fm.output_grid(4, 2048, k)
    assert plan.segment == pt_fm.output_grid(4, 2048, 64).segment
    assert plan.segment > 0 and plan.segment % 64 == 0
    segments = plan.workspace[0] if plan.workspace else 1
    starts = [z * plan.segment for z in range(segments)]
    assert all(lo % 16 == 0 for lo in starts) and starts[-1] < k
    assert segments * plan.segment >= k


@pytest.mark.parametrize("m", [4, 8192])
@pytest.mark.parametrize("k,padded", [(2048, 2048 + 128), (200, 256),
                                      (200, 512), (5632, 5632 + 512)])
def test_output_grid_zero_padding_only_appends(m, k, padded):
    """Padding K (to another bk) keeps the regime and the segment length,
    so every segment boundary below K stays where it was: the padded plan
    only extends the last segment with zeros or appends segments that hold
    nothing but zeros."""
    plan, more = (pt_fm.output_grid(m, 1024, kk) for kk in (k, padded))
    assert more.segment == plan.segment and more.rows == plan.rows
    if plan.segment:
        inside = [lo for lo in range(0, padded, more.segment) if lo < k]
        assert inside == list(range(0, k, plan.segment))
    else:
        assert plan.workspace is None and more.workspace is None


@pytest.mark.parametrize("shape,offset", [((4, 2048), 0), ((40, 70), 0),
                                          ((6, 36), 0), ((4, 64), 1)])
def test_aligned_rows_pads_what_tma_cannot_address(shape, offset):
    """The tensor-core kernels read rows of 16-byte multiples from 16-byte
    aligned bases: an operand that is so is passed as it is, any other is
    copied into rows zero-padded to a multiple of 8 elements, its values
    unchanged."""
    rows, cols = shape
    x = torch.arange(rows * cols, dtype=torch.float32).reshape(
        rows, cols).bfloat16()
    if offset:                  # the same values from a base 2 bytes in
        x = torch.cat([torch.zeros(1, dtype=torch.bfloat16),
                       x.flatten()])[1:].view(rows, cols)
    out, ld = pt_fm.aligned_rows(x)
    assert ld % 8 == 0 and ld >= cols and out.shape == (rows, ld)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert torch.equal(out[:, :cols], x) and not out[:, cols:].any()
    aligned = cols % 8 == 0 and x.data_ptr() % 16 == 0
    assert (out.data_ptr() == x.data_ptr()) == aligned


@pytest.mark.parametrize("shape,offset", [((4, 2048), 0), ((40, 70), 0),
                                          ((6, 40), 0), ((4, 64), 1)])
def test_aligned_rows_pads_int8_rows_to_16_elements(shape, offset):
    """An int8 payload's 16-byte unit is 16 elements: an aligned one is
    passed as it is, any other copied into rows zero-padded to a multiple
    of 16 elements, its values unchanged."""
    rows, cols = shape
    x = (torch.arange(rows * cols) % 255 - 127).to(torch.int8) \
        .reshape(rows, cols)
    if offset:                  # the same values from a base 1 byte in
        x = torch.cat([torch.zeros(1, dtype=torch.int8),
                       x.flatten()])[1:].view(rows, cols)
    out, ld = pt_fm.aligned_rows(x)
    assert ld % 16 == 0 and ld >= cols and out.shape == (rows, ld)
    assert out.dtype == torch.int8 and out.is_contiguous()
    assert out.data_ptr() % 16 == 0
    assert torch.equal(out[:, :cols], x) and not out[:, cols:].any()
    aligned = cols % 16 == 0 and x.data_ptr() % 16 == 0
    assert (out.data_ptr() == x.data_ptr()) == aligned


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mnk", [(4, 64, 2048), (2, 70, 36), (300, 128, 64)])
def test_tensor_core_operands_plan_and_storage(mnk, transposed):
    """The one launch recipe of the four tensor-core wrappers: the plan of
    the product's own (M, N, K), a workspace exactly when it splits K, and
    B's row-major storage — (K, N), or (N, K) for a transposed B — with
    both operands as ``aligned_rows`` gives them."""
    m, n, k = mnk
    a = torch.randn((m + 5, k)).bfloat16()      # padded rows past m
    store = torch.randn((n, k) if transposed else (k, n)).bfloat16()
    b = store.t() if transposed else store
    a2, lda, b2, ldb, plan, ws = pt_fm.tensor_core_operands(a, b, m)
    assert plan == pt_fm.output_grid(m, n, k)
    assert (ws is None) == (plan.workspace is None)
    if ws is not None:
        assert ws.shape == plan.workspace and ws.dtype == torch.float32
    for x, got, ld in ((a, a2, lda), (store, b2, ldb)):
        want, want_ld = pt_fm.aligned_rows(x)
        assert ld == want_ld and torch.equal(got, want)


@pytest.mark.parametrize("mnk", [(4, 64, 2048), (4, 64, 256), (300, 64, 64)])
def test_count_launch_counts_the_sum_only_when_k_splits(mnk):
    plan = pt_fm.output_grid(*mnk)
    launches = {"int8_matmul": 0, "int8_matmul_sum": 0}
    pt_fm.count_launch(launches, "int8_matmul", plan)
    pt_fm.count_launch(launches, "int8_matmul", plan)
    split = plan.workspace is not None
    assert split == (mnk[0] <= 16 and mnk[2] > 256)
    assert launches == {"int8_matmul": 2, "int8_matmul_sum": 2 * split}


def test_int8_widens_exactly_to_bf16():
    """The int8 tensor-core kernels' premise: every int8 value is a bf16
    value (|q| <= 128 fits bf16's 8-bit significand), and its product with
    a bf16 activation (8 + 7 significant bits) is exact in float32, so
    widening Q to bf16 and multiplying on the tensor cores computes the
    same products as the float32 plain version."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(q.to(torch.bfloat16).to(torch.int32),
                       q.to(torch.int32))
    rng = np.random.default_rng(8)
    a = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 7, 4096),
        [1.0, -1.0, 3.0e38 / 128, 2.0 ** -100]])).to(torch.bfloat16)
    prod32 = a.float()[:, None] * q.to(torch.bfloat16).float()[None, :]
    prod64 = a.double()[:, None] * q.double()[None, :]
    assert torch.equal(prod32.double(), prod64)


@pytest.mark.parametrize("mnk", [(0, 128, 128), (4, 0, 128), (4, 128, 0),
                                 (-4, 128, 128)])
def test_output_grid_refuses_non_positive_sizes(mnk):
    with pytest.raises(ValueError, match="non-positive"):
        pt_fm.output_grid(*mnk)


def test_flex_matmul_refuses_bad_operands():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="bad operand shapes"):
        pt_fm.flex_matmul(a, torch.zeros((9, 4)))
    with pytest.raises(ValueError, match="operands differ"):
        pt_fm.flex_matmul(a, torch.zeros((8, 4), dtype=torch.float64))
    for name in ("diagonal", "weight_sum", "output_sum"):   # launch keys
        with pytest.raises(ValueError, match="unknown stationarity"):
            pt_fm.flex_matmul(a, torch.zeros((8, 4)),
                              schedule=MatmulSchedule(name, 4, 4, 4))


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


def test_block_sparse_rows_keeps_the_unpadded_rows():
    """``rows``: A's rows past it only pad A to the blocks; C keeps the
    first ``rows`` rows, equal to the padded product's, and a count outside
    A is refused."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_sparse(rng, (3, 64), (3, 16), 0.7))
    b = torch.from_numpy(_sparse(rng, (64, 48), (16, 16), 0.5))
    xp = pt_fm.pad_to_blocks(a, 8, 16)
    meta = pt_sp.build_block_sparse_meta(pt_sp.block_bitmap(xp, 8, 16),
                                         pt_sp.block_bitmap(b, 16, 16))
    full = pt_bs.block_sparse_matmul(xp, b, meta, out_dtype=torch.float32)
    out = pt_bs.block_sparse_matmul(xp, b, meta, out_dtype=torch.float32,
                                    rows=3)
    assert out.shape == (3, 48) and torch.equal(out, full[:3])
    np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(), **TOL)
    for rows in (0, 9):
        with pytest.raises(ValueError, match="outside A"):
            pt_bs.block_sparse_matmul(xp, b, meta, rows=rows)


def test_block_sparse_refuses_non_multiples():
    meta = pt_sp.build_block_sparse_meta(torch.ones((1, 2), dtype=torch.bool),
                                         torch.ones((2, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="not block multiples"):
        pt_bs.block_sparse_matmul(torch.zeros((4, 9)), torch.zeros((9, 8)),
                                  meta)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
def test_flash_tc_check_admits_reordered_scores_and_rejects_controls(
        causal, window, monkeypatch):
    """The tensor-core tolerance of the bf16 flash kernel, on the CPU: a
    plain version whose float32 scores are summed otherwise (float64, then
    rounded, or as ``tensor_core_scores`` models the tensor cores) passes
    it, and every fragile p rounded the other way stays within the
    per-element bound; p kept in float32 before PV, the exact softmax
    rounded to bf16 and p rounded toward zero in one 16-row slice of each
    128 q rows (one faulty warp) fail it."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 256, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    kw = dict(causal=causal, window=window)
    plain = pt_ref.flash_attention_plain(q, k, v, **kw)
    bounds = pt_ref.flash_attention_flip_bounds(q, k, v, **kw)
    same = pt_ref.flash_tc_check(plain, plain, v, bounds)
    assert same.ratio == same.share == 0.0

    def check(out):
        return pt_ref.flash_tc_check(out, plain, v, bounds)

    matmul = torch.matmul

    def scores_in_float64(a, b):          # only q @ kᵀ (a transposed view)
        if b.dim() == 3 and b.stride(-2) == 1 and a.dtype == torch.float32:
            return matmul(a.double(), b.double()).float()
        return matmul(a, b)

    monkeypatch.setattr(pt_ref.torch, "matmul", scores_in_float64)
    reordered = pt_ref.flash_attention_plain(q, k, v, **kw)
    monkeypatch.undo()
    assert not torch.equal(reordered, plain)
    assert check(reordered).ok
    assert not torch.equal(bounds.modelled, plain)
    assert check(bounds.modelled).ok
    assert check(bounds.flipped).ratio <= 1.0
    assert not check(pt_ref.flash_attention_plain(q, k, v.float(), **kw)).ok
    exact = pt_ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                       **kw)
    assert not check(exact.bfloat16()).ok
    warp = (torch.arange(q.shape[1]) % 128 < 16)[None, :, None]
    faulty = torch.where(warp, pt_ref.flash_attention_plain(
        q, k, v, truncate_p=True, **kw), plain)
    assert not check(faulty).ok


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_tensor_core_scores_truncate_each_group(hd):
    """``tensor_core_scores``: one 16-product group is its exact sum
    rounded toward zero to float32; over hd/16 groups each truncation errs
    by less than one float32 ulp of the running sum."""
    rng = np.random.default_rng(hd)
    q, k = (torch.from_numpy(rng.standard_normal((2, 32, hd))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    tc = pt_ref.tensor_core_scores(q, k).numpy().astype(np.float64)
    exact = (q.double() @ k.double().transpose(1, 2)).numpy()
    if hd == 16:
        near = exact.astype(np.float32)
        over = np.abs(near.astype(np.float64)) > np.abs(exact)
        rz = np.where(over, np.nextafter(near, np.float32(0)), near)
        np.testing.assert_array_equal(tc, rz.astype(np.float64))
    partial = (q.double().abs() @ k.double().abs().transpose(1, 2)).numpy()
    assert np.all(np.abs(tc - exact) <= (hd // 16) * 2.0 ** -23 * partial)
    assert not np.array_equal(tc, exact.astype(np.float32))
