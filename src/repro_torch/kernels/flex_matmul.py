"""Schedule-flexible dense matmul on Hopper — FlexNN's per-layer dataflow.

Wrappers of the CUDA kernels in ``csrc/flex_matmul.cu``, which replace the
JAX package's Pallas kernels ``_os_kernel`` (src/repro/kernels/
flex_matmul.py:52, launched at :102) and ``_revisit_kernel`` (:68, launched
at :118 weight-stationary and :133 input-stationary).  A ``MatmulSchedule``
descriptor picks the entry point and the (bm, bn, bk) blocks:

  output : one CUDA block per output tile, K loop, accumulator in
           registers (bf16 on the tensor cores, over the plan of
           ``output_grid``, which ``bs_matmul`` shares);
  weight : per K-block, a B tile held in shared memory while the M rows
           stream past it, one float32 partial per K-block added into the
           output in K-block order (bf16 on the tensor cores, over the grid
           that ``weight_grid`` plans);
  input  : the mirror image over M-tiles, an A tile resident while the
           N-strips stream past it (bf16 on the same tensor-core tile, over
           the grid that ``input_grid`` plans: the same partials added in
           the same order, so it equals ``weight`` bit for bit).

At decode (M = n_slots) all three are bound by device-memory bytes (the
weight read once).  CPU tensors take the plain version
(``ref.matmul_ref``); CUDA tensors launch a kernel or raise.

Over a leading expert axis — the MoE expert contraction (E, C, K) @
(E, K, N) — bf16 output-stationary at C <= 16 (decode) is one launch over
all E experts (the grid's y axis over the experts, each expert bit-equal
to its own launch); anything else runs the 2-D kernels expert by expert,
as the reference's Pallas path unrolls them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.scheduler import H100
from repro_torch.core.stacks import pad_to_blocks
from repro_torch.kernels import accounting, build
from repro_torch.kernels.ref import expert_matmul_ref, matmul_ref

DEFAULT_BLOCKS = (128, 128, 128)

STATIONARITIES = ("output", "weight", "input")
# launches of each CUDA kernel (bumped only where it is launched):
# ``output_sum`` / ``weight_sum`` / ``input_sum`` are the second kernel of
# a split output- / weight- / input-stationary grid; ``output_experts``
# (+ ``_sum``) the output-stationary kernel's expert-batched launches
LAUNCHES = {"output": 0, "weight": 0, "input": 0, "output_sum": 0,
            "weight_sum": 0, "input_sum": 0, "output_experts": 0,
            "output_experts_sum": 0}


def _groups(own: int, other: int, device) -> int:
    """How many blocks share one strip's other axis so that a decode-shaped
    matmul (a single M-strip) still spreads over the card: about two
    blocks per SM in all, at most one per tile."""
    return max(1, min(other, (2 * _sms(device)) // max(own, 1)))


# The bf16 revisit kernels (csrc/flex_matmul.cu, csrc/mma.cuh): output
# columns per block, the staged chunk's K columns; the input-stationary
# block's B ring, its staged float32 output tiles and their row stride.
# These and the two shared-memory sizes below mirror mma.cuh's kTN, kKC,
# kRing, kOutTiles, kOutLd, ws_smem_bytes and is_smem_bytes, which the
# launcher checks; tests/test_torch_kernels.py holds them equal.
WS_STRIP = 128
WS_CHUNK = 64
IS_RING, IS_OUT_TILES, IS_OUT_LD = 3, 2, WS_STRIP + 8
# float32 bytes the split grid's workspace may take (decode mlp.in: 1.4 MB)
WORKSPACE_CAP = 256 << 20


def revisit_rows(m: int) -> int:
    """M-tile height of both bf16 revisit kernels for ``m`` (padded) rows:
    16 (the decode rows, zero-padded in shared memory) or 64."""
    return 16 if m <= 16 else 64


def ws_smem_bytes(rows: int, bk: int) -> int:
    """Shared memory of a weight-stationary block: the K-block's B strip
    (bk rounded up to 64, x 128) and two A chunks (rows x 64), bf16."""
    kpad = -(-bk // WS_CHUNK) * WS_CHUNK
    return 2 * (kpad * WS_STRIP + 2 * rows * WS_CHUNK)


def is_smem_bytes(rows: int, bk: int, split: bool) -> int:
    """Shared memory of an input-stationary block: two K-blocks of A (rows
    x bk rounded up to 64) and the B ring, bf16, and, owning, the float32
    output tiles read ahead of their read-modify-write."""
    kpad = -(-bk // WS_CHUNK) * WS_CHUNK
    return (2 * (2 * rows * kpad + IS_RING * WS_CHUNK * WS_STRIP)
            + (0 if split else IS_OUT_TILES * rows * IS_OUT_LD * 4))


def _revisit_checks(m, n, k, bm, bn, bk, sms) -> None:
    if min(m, n, k, bm, bn, bk, sms) <= 0:
        raise ValueError(f"non-positive size in M={m} N={n} K={k} "
                         f"blocks=({bm}, {bn}, {bk}) SMs={sms}")
    if m % bm or n % bn or k % bk:
        raise ValueError(f"M={m} N={n} K={k} are not multiples of the "
                         f"blocks ({bm}, {bn}, {bk})")


@dataclass(frozen=True)
class WeightGrid:
    """Launch plan of the bf16 weight-stationary kernel.

    ``split``: one block per (N-strip, K-block) writes its float32 partial
    into a ``workspace`` of shape (tk, M, N), and a second pass adds the
    partials in K-block order; otherwise each block owns an (N-strip,
    M-tile group) and walks the K-blocks itself.  ``grid`` is (strips,
    K-blocks or groups); ``rows`` the M-tile height (16 or 64)."""
    split: bool
    grid: Tuple[int, int]
    rows: int
    workspace: Optional[Tuple[int, int, int]]


def weight_grid(m: int, n: int, k: int, bm: int, bn: int, bk: int, sms: int,
                cap: int = WORKSPACE_CAP) -> WeightGrid:
    """Plan the bf16 weight-stationary launch of C[m, n] = A[m, k] @ B[k, n]
    (operands already padded to the (bm, bn, bk) blocks) on ``sms`` SMs.

    The owning grid has ceil(n / 128) strips times at most
    min(M-tiles, 2·sms // strips) groups.  When that leaves SMs idle (a
    decode matmul has a single M-tile) and there are several K-blocks, the
    K-blocks run in parallel instead — tk · strips blocks — provided their
    float32 partials (tk·m·n·4 bytes) fit under ``cap``.  Raises on
    operands that are not block multiples and on a K-block whose B tile
    does not fit in a block's shared memory."""
    _revisit_checks(m, n, k, bm, bn, bk, sms)
    rows = revisit_rows(m)
    smem = ws_smem_bytes(rows, bk)
    if smem > H100.vmem_bytes:
        raise ValueError(f"a {bk}-row K-block of {WS_STRIP} columns takes "
                         f"{smem} bytes of shared memory, over "
                         f"{H100.vmem_bytes}")
    strips, tk, mtiles = -(-n // WS_STRIP), k // bk, -(-m // rows)
    groups = max(1, min(mtiles, (2 * sms) // strips))
    if strips * groups < sms and tk > 1 and 4 * tk * m * n <= cap:
        return WeightGrid(True, (strips, tk), rows, (tk, m, n))
    return WeightGrid(False, (strips, groups), rows, None)


@dataclass(frozen=True)
class InputGrid:
    """Launch plan of the bf16 input-stationary kernel, the mirror of
    ``WeightGrid``.

    ``split``: one block per (K-block, strip group) holds that K-block of
    A and writes its strips' float32 partials into a ``workspace`` of shape
    (tk, M, N), and a second pass adds them in K-block order; otherwise each
    block owns an (M-tile, strip group) and walks the K-blocks itself.
    ``grid`` is (K-blocks or M-tiles, strip groups); ``rows`` the M-tile
    height (16 or 64, as ``weight_grid``'s, so that the two kernels form
    the same partials)."""
    split: bool
    grid: Tuple[int, int]
    rows: int
    workspace: Optional[Tuple[int, int, int]]


def input_grid(m: int, n: int, k: int, bm: int, bn: int, bk: int, sms: int,
               cap: int = WORKSPACE_CAP) -> InputGrid:
    """Plan the bf16 input-stationary launch of C[m, n] = A[m, k] @ B[k, n]
    (operands already padded to the (bm, bn, bk) blocks) on ``sms`` SMs.

    The owning grid has ceil(m / rows) M-tiles times at most
    min(strips, 2·sms // M-tiles) groups of 128-column strips.  When that
    leaves SMs idle (a decode matmul has a single M-tile) and there are
    several K-blocks, the K-blocks run in parallel instead — tk times at
    most min(strips, 2·sms // tk) strip groups — provided their float32
    partials (tk·m·n·4 bytes) fit under ``cap``.  B streams past A in
    64-deep chunks, so shared memory bounds only the resident A (two
    K-blocks of it, rows x bk rounded up to 64, bf16) beside the ring and,
    owning, the staged output tiles.  Raises on operands that are not block
    multiples and on a K-block of A that does not fit."""
    _revisit_checks(m, n, k, bm, bn, bk, sms)
    rows = revisit_rows(m)
    strips, tk, mtiles = -(-n // WS_STRIP), k // bk, -(-m // rows)
    groups = max(1, min(strips, (2 * sms) // mtiles))
    split = mtiles * groups < sms and tk > 1 and 4 * tk * m * n <= cap
    smem = is_smem_bytes(rows, bk, split)
    if smem > H100.vmem_bytes:
        raise ValueError(f"a {bk}-column K-block of {rows} rows of A takes "
                         f"{smem} bytes of shared memory with its ring, over "
                         f"{H100.vmem_bytes}")
    if split:
        return InputGrid(True, (tk, max(1, min(strips, (2 * sms) // tk))),
                         rows, (tk, m, n))
    return InputGrid(False, (mtiles, groups), rows, None)


# The output-stationary tensor-core kernel (csrc/os_mma.cuh), shared by
# bf16 ``fm_output`` and ``bs_matmul`` and by bf16-activation ``i8_matmul``
# and ``bs_matmul_scaled``: a CTA's rows at M <= 16 (mma.sync) and
# above (wgmma; every CTA owns 128 columns), and the K segment of the
# M <= 16 regime.
OS_SKINNY_ROWS = 16
OS_WIDE_ROWS = 128
OS_SEGMENT = 256
# K elements of one staged chunk and output columns of one CTA, in both
# regimes: the grain at which ``bs_matmul`` skips.  A CTA multiplies every
# chunk that holds a block listed for any column tile it overlaps, so the
# lists of a pruned plan tier, which leave non-zero blocks out, are walked
# exactly only when bk is a multiple of OS_CHUNK and bn of OS_COLS.
OS_CHUNK = 64
OS_COLS = 128


@dataclass(frozen=True)
class OutputGrid:
    """Launch plan of the output-stationary tensor-core kernel, the same
    for ``fm_output`` and ``bs_matmul`` (bf16) and for ``i8_matmul`` and
    ``bs_matmul_scaled`` (bf16 x int8); the kernel takes ``rows`` and
    ``segment`` and refuses a ``rows`` that does not follow M.

    ``rows``: the CTA tile's height, 16 (``mma.sync``) or 128 (``wgmma``).
    ``segment``: the K elements one CTA sums (0: all of K).
    ``workspace``: the float32 partials (segments, m, n) that a second
    kernel adds in segment order, when there are several."""
    rows: int
    segment: int
    workspace: Optional[Tuple[int, int, int]]


def output_grid(m: int, n: int, k: int) -> OutputGrid:
    """Plan the output-stationary tensor-core launch of C[m, n] = A[m, k] @
    B[k, n] (``fm_output`` and ``i8_matmul`` dense, ``bs_matmul`` and
    ``bs_matmul_scaled`` block-sparse); ``m`` counts the product's own
    rows, before any padding to the blocks.

    It sees no blocks, so each output element's summation order — 16-wide
    K groups from offset 0, ascending, inside segments of a constant
    length, the segments added in ascending order — is the same for the
    dense and the block-sparse product under any blocks, and the dense
    table's results equal the plan's bit for bit (csrc/os_mma.cuh).  The
    regime follows M alone.  At M <= 16 (decode) a 128-column strip per CTA
    would give a 2048-wide site 16 CTAs on 132 SMs, so K is cut into
    segments of 256 (8 per strip at K = 2048); above, 128 x 128 tiles fill
    the card (2816 at M = 8192, N = 5632) and K is not split.  Zero padding
    at the end of K only appends zero groups or segments."""
    if min(m, n, k) <= 0:
        raise ValueError(f"non-positive size in M={m} N={n} K={k}")
    if m > OS_SKINNY_ROWS:
        return OutputGrid(OS_WIDE_ROWS, 0, None)
    segments = -(-k // OS_SEGMENT)
    return OutputGrid(OS_SKINNY_ROWS, OS_SEGMENT,
                      (segments, m, n) if segments > 1 else None)


def output_workspace(plan: OutputGrid, device,
                     lead: Tuple[int, ...] = ()) -> Optional[torch.Tensor]:
    """The float32 segment partials of ``plan`` — lead + (segments, m, n),
    ``lead`` (E,) for an expert-batched launch — or None (one segment)."""
    if plan.workspace is None:
        return None
    return torch.empty(tuple(lead) + plan.workspace, dtype=torch.float32,
                       device=device)


def aligned_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A row-major bf16 or int8 matrix, or a stack of them (..., rows,
    cols), as the tensor-core kernels read it (TMA and ``cp.async`` move
    16-byte units), and its row stride in elements: ``x`` itself when it is
    contiguous and its base and row stride are 16-byte multiples, else a
    copy with each row zero-padded to a multiple of 16 bytes (8 bf16 or 16
    int8 elements); in a stack each matrix then starts rows·stride
    elements after the previous one.  The kernels still take the logical K
    and N, and read nothing past them."""
    *lead, cols = x.shape
    unit = 16 // x.element_size()
    ld = -(-cols // unit) * unit
    if ld == cols and x.is_contiguous() and accounting.aligned16(x):
        return x, ld
    out = x.new_zeros((*lead, ld))
    out[..., :cols] = x
    return out, ld


def tensor_core_operands(a: torch.Tensor, b: torch.Tensor, m: int):
    """What an output-stationary tensor-core launch of the ``m`` unpadded
    rows of A[..., :, K] @ B[..., K, N] takes (``fm_output``,
    ``bs_matmul``, ``i8_matmul``, ``bs_matmul_scaled``; one product or a
    stack of them): (A, lda, B's storage, ldb, plan, workspace) — A and B's
    row-major storage, (K, N) or for a transposed ``b`` (N, K), as
    ``aligned_rows`` gives them, the plan ``output_grid(m, N, K)`` and its
    workspace (with the stack's leading axis) or None.  The kernels read
    A's first ``m`` rows (of each matrix of a stack)."""
    k, n = b.shape[-2:]
    plan = output_grid(m, n, k)
    ws = output_workspace(plan, a.device, a.shape[:-2])
    a, lda = aligned_rows(a)
    b, ldb = aligned_rows(b.transpose(-1, -2) if build.b_layout(b) else b)
    return a, lda, b, ldb, plan, ws


def count_launch(launches: dict, key: str, plan: OutputGrid) -> None:
    """Count one launch of a tensor-core kernel under ``plan`` in
    ``launches[key]``, and its segment sum in ``launches[key + "_sum"]``
    when the plan splits K."""
    launches[key] += 1
    if plan.workspace is not None:
        launches[f"{key}_sum"] += 1


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(a: torch.Tensor, b: torch.Tensor, stationarity: str, bm: int,
            bn: int, bk: int, out_dtype, rows: int) -> torch.Tensor:
    """The kernel for padded operands; ``rows``: A's rows before padding.
    A leading expert axis reaches only bf16 output-stationary at rows <= 16
    (one launch over the experts).  Fake operands (a trace) get the
    launch's allocations and no launch (``accounting``)."""
    if not a.is_contiguous():
        raise ValueError("A must be row-major contiguous")
    b_trans = build.b_layout(b)
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    tm, tn = m // bm, n // bn
    fake = accounting.is_fake(a)
    lib = None if fake else build.library("flex_matmul")
    stream = None if fake else build.stream_ptr(a.device)
    code = build.dtype_code(a.dtype)
    second = None                 # the key of a second kernel's launch
    grid = None                   # the plan of a tensor-core launch
    key = stationarity
    if stationarity == "output":
        ws, args = None, (k, k if b_trans else n, bm, bn, bk, 0, 0)
        strides = (0, 0)
        if a.dtype == torch.bfloat16:
            # the tensor cores take ragged M: the unpadded rows only, whose
            # count picks the plan (as for ``bs_matmul``)
            m = rows
            a, lda, b, ldb, grid, ws = tensor_core_operands(a, b, m)
            args = (lda, ldb, bm, bn, bk, grid.rows, grid.segment)
            strides = (a.shape[-2] * lda, b.shape[-2] * ldb)
        out = torch.empty(lead + (m, n), dtype=out_dtype, device=a.device)
        if fake:
            return out
        err = lib.fm_output(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None if ws is None else ws.data_ptr(), m, n, k,
                            *args, b_trans, code, build.dtype_code(out_dtype),
                            lead[0] if lead else 1, *strides, stream)
        key += "_experts" if lead else ""
    elif stationarity in ("weight", "input"):
        # the revisit dataflows accumulate in a float32 output, cast after
        weight = stationarity == "weight"
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        if a.dtype == torch.bfloat16:
            plan = (weight_grid if weight else input_grid)(
                m, n, k, bm, bn, bk,
                accounting.H100_SMS if fake else _sms(a.device),
                WORKSPACE_CAP)
            ws = None if plan.workspace is None else torch.empty(
                plan.workspace, dtype=torch.float32, device=a.device)
            if fake:
                return out.to(out_dtype)
            args = (*plan.grid, int(plan.split), plan.rows)
            second = f"{stationarity}_sum" if plan.split else None
        elif fake:
            return out.to(out_dtype)
        else:
            own, other = (tn, tm) if weight else (tm, tn)
            ws, args = None, (own, _groups(own, other, a.device), 0, 0)
        err = (lib.fm_weight if weight else lib.fm_input)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, bm, bn, bk,
            *args, b_trans, code, stream)
    else:
        raise ValueError(f"unknown stationarity {stationarity!r}")
    build.check(err, f"flex_matmul[{key}]")
    if grid is not None:          # with its segment sum, if it has one
        count_launch(LAUNCHES, key, grid)
    else:
        LAUNCHES[key] += 1
        if second is not None:    # a summing kernel ran after it
            LAUNCHES[second] += 1
    return out.to(out_dtype)


def flex_matmul(a: torch.Tensor, b: torch.Tensor, *, schedule=None,
                out_dtype=None) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N] under a FlexNN ``MatmulSchedule``.

    ``schedule`` carries (stationarity, bm, bn, bk); None uses the
    output-stationary default with 128³ blocks.  Blocks are clamped to the
    operand dims and the operands zero-padded to block multiples.  ``b``
    may be the transposed view of a row-major (N, K) matrix (the stored
    lm_head), which the kernels read in place.

    Over a leading expert axis, A[E, M, K] @ B[E, K, N] → C[E, M, N],
    expert e's product as the 2-D call runs it: on CUDA a bf16
    output-stationary product of at most ``OS_SKINNY_ROWS`` rows is one
    launch over every expert, each expert bit-equal to its own launch;
    other stationarities, float32 and more rows launch the 2-D kernels
    expert by expert.  ``b`` may be the transposed view of a row-major
    (E, N, K) stack (the backward's Wᵀ), which either reads in place; on
    CUDA a B that is neither is refused (``build.b_layout``).  CPU tensors
    take the plain version."""
    if schedule is None:
        stationarity, (bm, bn, bk) = "output", DEFAULT_BLOCKS
    else:
        stationarity = schedule.stationarity
        bm, bn, bk = schedule.bm, schedule.bn, schedule.bk
    if (a.dim() not in (2, 3) or b.dim() != a.dim()
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"operands differ: {a.device}/{a.dtype} vs "
                         f"{b.device}/{b.dtype}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    out_dtype = out_dtype or a.dtype
    card = accounting.on_card(a)
    if card and a.dim() == 3 and not (
            stationarity == "output" and a.dtype == torch.bfloat16
            and m <= OS_SKINNY_ROWS):
        return torch.stack([flex_matmul(a[i], b[i], schedule=schedule,
                                        out_dtype=out_dtype)
                            for i in range(a.shape[0])])
    ap = pad_to_blocks(a, bm, bk)
    bp = pad_to_blocks(b, bk, bn)
    if not card and a.device.type == "cpu":
        if stationarity not in STATIONARITIES:
            raise ValueError(f"unknown stationarity {stationarity!r}")
        # row-major B: the CPU library's order then does not depend on
        # B's layout, as the kernels' does not
        ref = expert_matmul_ref if a.dim() == 3 else matmul_ref
        out = ref(ap, bp.contiguous()).to(out_dtype)
    elif card:
        # the product's own work and operands: what the block padding adds
        # depends on the blocks, not on the function
        e = a.shape[0] if a.dim() == 3 else 1
        accounting.count(f"flex_{stationarity}", 2 * e * m * n * k,
                         e * (m * k + k * n) * a.element_size()
                         + e * m * n * out_dtype.itemsize)
        out = _launch(ap, bp, stationarity, bm, bn, bk, out_dtype, m)
    else:
        raise ValueError(f"unsupported device {a.device}")
    return out[..., :m, :n]
