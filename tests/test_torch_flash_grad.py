"""The flash branch's gradient: the plain version of ``fa_backward``
(``ref.flash_attention_backward_plain``, what the CPU runs and what the card
holds the kernel to) against ``jax.vjp`` of the reference's flash-attention
oracle (``repro.kernels.ref.flash_attention_ref``) for causal, windowed,
Sq < Skv and full attention, through ``ops.flash_attention``'s autograd
Function with and without ``use_kernels``; the forward's row log-sum-exp;
the bf16 backward check (``ref.flash_backward_check``) accepting the
tensor-core model and rejecting truncated P and dS; what raises.

Tolerance: float32 on both sides, the same function summed in other
orders — |port − ref| ≤ 1e-5·max|ref| + 1e-7 per output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kref
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels.ref import (BWD_RMS, BWD_WORST,
                                     flash_attention_backward_plain,
                                     flash_attention_plain,
                                     flash_backward_check)

CASES = [  # (bh, sq, skv, hd, causal, window)
    (2, 256, 256, 64, True, 0),
    (2, 256, 256, 64, True, 64),
    (2, 128, 256, 64, True, 0),
    (2, 128, 256, 128, False, 0),
    (2, 128, 256, 256, True, 64),
    # the bf16 kernels' tiling edges: one 64-row tile, a 128-row block with
    # a ragged half (S 192), Sq < Skv by 64, windows of 64 and 100,
    # non-causal at hd 256
    (1, 64, 64, 64, True, 0),
    (2, 192, 192, 64, True, 100),
    (1, 192, 192, 128, True, 64),
    (1, 64, 128, 256, True, 0),
    (1, 128, 128, 256, False, 0),
]


def _inputs(bh, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(bh, skv, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    return q, k, v, do


def _ref_grads(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: ref_kref.flash_attention_ref(
        a, b, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_flash_grads_equal_jax_vjp(case, kernels):
    bh, sq, skv, hd, causal, window = case
    q, k, v, do = _inputs(bh, sq, skv, hd)
    want = _ref_grads(q, k, v, do, causal, window)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=kernels)):
        o = pt_ops.flash_attention(*ts, causal=causal, window=window,
                                   bq=64, bkv=128)
    o.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7)


def test_lse_leaves_the_output_alone():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 256, 256, 64))
    o = pt_fa.flash_attention(q, k, v, causal=True)
    o2, lse = pt_fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o, o2) and lse.shape == (2, 256)
    s = torch.einsum("bqh,bkh->bqk", q.double(), k.double()) * 64 ** -0.5
    s = s.masked_fill(torch.ones(256, 256).triu(1).bool(), -torch.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES[:3])
def test_bf16_check_accepts_tensor_cores_rejects_truncation(case):
    """The bf16 gate the card applies to ``fa_backward``: the plain version
    with S and dP summed as ``tensor_core_scores`` models the tensor cores
    passes it; P and dS truncated toward zero fail it."""
    bh, sq, skv, hd, causal, window = case
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(bh, sq, skv, hd, seed=1))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    plain = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    weight = flash_attention_backward_plain(q, k, v, o, lse, do,
                                            magnitudes=True, **kw)
    tc = flash_attention_backward_plain(q, k, v, o, lse, do, tc_scores=True,
                                        **kw)
    trunc = flash_attention_backward_plain(q, k, v, o, lse, do,
                                           truncate=True, **kw)
    for a, p, w in zip(tc, plain, weight):
        chk = flash_backward_check(a, p, w)
        assert chk.ok(), chk
        assert chk.rms < BWD_RMS / 8 and chk.worst < BWD_WORST / 8, chk
    assert not all(flash_backward_check(a, p, w).ok()
                   for a, p, w in zip(trunc, plain, weight))
    assert all(flash_backward_check(a, p, w).rms > 2 * BWD_RMS
               for a, p, w in zip(trunc[1:], plain[1:], weight[1:]))


def test_plain_backward_is_exact_in_float64():
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _inputs(2, 128, 192, 64, seed=2))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    from repro_torch.kernels.ref import flash_attention_ref
    flash_attention_ref(*ts, causal=True, window=96).backward(do)
    o, lse = flash_attention_plain(q, k, v, causal=True, window=96,
                                   return_lse=True)
    got = flash_attention_backward_plain(q, k, v, o, lse, do, causal=True,
                                         window=96)
    for g, t in zip(got, ts):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("hd", [32, 256])
def test_kernel_backward_head_dims_raise_under_grad(hd):
    """hd 32 has no kernel backward and raises under grad; hd 256 has one
    (both kernel passes take it): the kernel branch's gradient on the CPU
    equals the plain branch's."""
    q = torch.randn(2, 64, hd, requires_grad=True)
    if hd in pt_fa.BACKWARD_HEAD_DIMS:
        grads = []
        for kernels in (True, False):
            qa = q.detach().clone().requires_grad_()
            with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=kernels)):
                o = pt_ops.flash_attention(qa, qa, qa, causal=True, bq=64,
                                           bkv=64)
            o.sum().backward()
            grads.append(qa.grad)
        assert torch.equal(grads[0], grads[1])
        o, lse = pt_fa.flash_attention(q.detach(), q.detach(), q.detach(),
                                       return_lse=True)
        assert all(g.shape == q.shape for g in pt_fa.flash_attention_backward(
            q.detach(), q.detach(), q.detach(), o, lse, q.detach()))
        return
    with pt_ops.exec_config(pt_ops.ExecConfig(use_kernels=True)):
        with pytest.raises(NotImplementedError, match="head dims"):
            pt_ops.flash_attention(q, q, q, causal=True)
        with torch.no_grad():          # the forward alone still runs
            assert pt_ops.flash_attention(q, q, q, causal=True).shape == \
                q.shape
    with pytest.raises(ValueError, match="head dim"):
        pt_fa.flash_attention_backward(q, q, q, q, torch.zeros(2, 64), q)


def test_backward_wrapper_checks_its_operands():
    q = torch.randn(2, 64, 64)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="do not match"):
        pt_fa.flash_attention_backward(q, q, q, q, lse, q[:, :32])
    with pytest.raises(TypeError):
        pt_fa.flash_attention_backward(q, q, q, q, lse.double(), q)


def test_dots_tape_replays_flash():
    """The flash Function hands back its recorded (o, lse) under replay and
    still gives the same gradient."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 64))
    ec = pt_ops.ExecConfig(use_kernels=True)
    tape = pt_ops.DotsTape()
    with pt_ops.exec_config(ec), pt_ops.recording(tape):
        o1 = pt_ops.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert len(tape.saved) == 1 and torch.equal(tape.saved[0][0], o1)
    calls = []
    orig = pt_fa.flash_attention
    pt_fa.flash_attention = lambda *a, **kw: calls.append(1) or orig(*a,
                                                                       **kw)
    try:
        qr = q.detach().clone().requires_grad_()
        with pt_ops.exec_config(ec), pt_ops.replaying(tape):
            o2 = pt_ops.flash_attention(qr, k, v, causal=True)
    finally:
        pt_fa.flash_attention = orig
    assert calls == [] and torch.equal(o1, o2)
    o2.backward(do)
    q2 = q.detach().clone().requires_grad_()
    with pt_ops.exec_config(ec):
        pt_ops.flash_attention(q2, k, v, causal=True).backward(do)
    assert torch.equal(qr.grad, q2.grad)


def test_parse_sass_counts_opcodes_per_kernel():
    """``build.parse_sass``, which the card's gates on the bf16 backward
    read (wgmma only, TMA loads, no atomics): opcodes by their first dotted
    part, guard predicates skipped, encoding lines ignored."""
    from repro_torch.kernels import build
    text = """
        Function : _ZN3fab16fab_q_kernel_mmaILi64EEEv
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                                               /* 0x000a0000ff017b82 */
        /*0fb0*/                   HGMMA.64x64x16.F32.BF16 R184, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0fc0*/              @!P0 UTMALDG.2D [UR8], [UR4] ;
        /*0fd0*/                   HGMMA.64x64x16.F32.BF16 R184, gdesc[UR4], R184, gsb0 ;
        Function : _ZN3fab12fab_q_kernelILi64EEEv
        /*0000*/                   FFMA R0, R1, R2, R0 ;
        /*0010*/               @P1 RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
"""
    got = build.parse_sass(text)
    assert got == {"_ZN3fab16fab_q_kernel_mmaILi64EEEv":
                   {"LDC": 1, "HGMMA": 2, "UTMALDG": 1},
                   "_ZN3fab12fab_q_kernelILi64EEEv": {"FFMA": 1, "RED": 1}}


def test_backward_kernel_faults_reads_sass_and_ptxas_notes():
    """``build.backward_kernel_faults``, the card's one rule for the bf16
    backward kernels: a kernel on HGMMA with TMA loads and no atomics is
    clean; HMMA, a missing UTMALDG, an atomic or a C75xx note naming it is
    a fault; other kernels are not judged."""
    from repro_torch.kernels import build
    good, bad = "_ZN3fab17fab_kv_kernel_mmaILi64EEEv", \
        "_ZN3fab16fab_q_kernel_mmaILi64EEEv"
    ops = {good: {"HGMMA": 4, "UTMALDG": 2},
           bad: {"HGMMA": 2, "HMMA": 1, "RED": 3},
           "_ZN3fab12fab_q_kernelILi64EEEv": {"RED": 1}}
    log = ("ptxas info    : (C7511) Potential Performance Loss: "
           "wgmma.mma_async instructions are serialized due to insufficient "
           f"register resources in the function '{bad}'\n")
    got = build.backward_kernel_faults(ops, log)
    assert sorted(got) == sorted([good, bad]) and got[good] == []
    assert len(got[bad]) == 4 and "(C7511)" in got[bad][3], got[bad]
    assert build.backward_kernel_faults({bad: ops[bad]})[bad][:3] == \
        got[bad][:3]
