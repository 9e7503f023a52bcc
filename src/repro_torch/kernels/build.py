"""Build and load the port's CUDA kernels: ``nvcc`` by hand into shared
libraries with a plain C interface, loaded through ``ctypes``.

Each ``csrc/<name>.cu`` (plus the shared ``*.cuh`` headers) compiles to
``build/kernels/<name>-<hash>.so`` at the repository root, keyed by a hash of
the sources and flags, at first use.  ``build_all()`` starts one ``nvcc``
per source at once and waits for all of them.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("block_sparse", "flex_matmul", "int8_matmul", "flash_attention")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of every exported entry point (argtypes, restype int =
# the cudaError_t of the launch)
SIGNATURES = {
    "block_sparse": {
        "bs_matmul": [_P] * 6 + [_I] * 15 + [_L] * 4 + [_P],
        "bs_matmul_scaled": [_P] * 7 + [_I] * 15 + [_L] * 4 + [_P],
    },
    "flex_matmul": {
        "fm_output": [_P] * 4 + [_I] * 14 + [_L] * 2 + [_P],
        "fm_weight": [_P] * 4 + [_I] * 12 + [_P],
        "fm_input": [_P] * 4 + [_I] * 12 + [_P],
    },
    "int8_matmul": {
        "i8_matmul": [_P] * 5 + [_I] * 13 + [_P],
    },
    "flash_attention": {
        "fa_forward": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "fa_backward": [_P] * 10 + [_I] * 6 + [_F, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source started
    together; returns the wall seconds spent.  Raises with nvcc's output on
    a failed build."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs: List = []
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}:\n{out}")
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def parse_sass(text: str) -> Dict[str, Dict[str, int]]:
    """Instruction counts by opcode (its first dotted part: ``HGMMA``,
    ``UTMALDG``, ``ATOMG``, ...; a guard predicate skipped) in each kernel
    of ``cuobjdump -sass`` output, by mangled kernel name."""
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {}
        elif fn is not None and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def sass_ops(name: str) -> Dict[str, Dict[str, int]]:
    """``parse_sass`` of the library built from ``csrc/<name>.cu`` (builds
    it first)."""
    library(name)
    return parse_sass(subprocess.run(
        [_cuobjdump(), "-sass", str(_target(name))], capture_output=True,
        text=True, check=True).stdout)


def backward_kernel_faults(ops: Dict[str, Dict[str, int]],
                           log: str = "") -> Dict[str, List[str]]:
    """What each bf16 ``fa_backward`` kernel (``fab_kv_kernel_mma`` /
    ``fab_q_kernel_mma``) among ``ops`` (``parse_sass`` counts) breaks of
    its design, empty when nothing: products on HGMMA alone (no HMMA),
    tiles loaded by TMA (UTMALDG), no atomic instruction (ATOM / ATOMG /
    ATOMS / RED: every output element has one owner), and no ptxas note
    (C75xx) in the build ``log`` that its wgmma pipeline is serialised."""
    faults: Dict[str, List[str]] = {}
    for fn, c in ops.items():
        if "fab_kv_kernel_mma" not in fn and "fab_q_kernel_mma" not in fn:
            continue
        bad = faults[fn] = []
        if not c.get("HGMMA") or c.get("HMMA"):
            bad.append(f"products not on wgmma alone: HGMMA "
                       f"{c.get('HGMMA', 0)}, HMMA {c.get('HMMA', 0)}")
        if not c.get("UTMALDG"):
            bad.append("no TMA load (UTMALDG)")
        atomics = sum(c.get(op, 0) for op in ("ATOM", "ATOMG", "ATOMS",
                                              "RED"))
        if atomics:
            bad.append(f"{atomics} atomic instructions")
        bad.extend(line.strip() for line in log.splitlines()
                   if "(C75" in line and f"'{fn}'" in line)
    return faults


def tensor_core_ops(name: str) -> Dict[str, int]:
    """Tensor-core instructions (SASS ``HMMA`` / ``HGMMA``) in each kernel
    of the library built from ``csrc/<name>.cu``, by mangled kernel name."""
    return {fn: ops.get("HMMA", 0) + ops.get("HGMMA", 0)
            for fn, ops in sass_ops(name).items()}


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({_error_name(err)})")


def _error_name(err: int) -> str:
    try:
        rt = ctypes.CDLL("libcudart.so")
    except OSError:
        return "cudaError_t"
    rt.cudaGetErrorString.restype = ctypes.c_char_p
    rt.cudaGetErrorString.argtypes = [ctypes.c_int]
    return rt.cudaGetErrorString(err).decode()


# ---------------------------------------------------------------------------
# launch helpers shared by the wrappers
# ---------------------------------------------------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def dtype_code(dtype, allowed=(torch.float32, torch.bfloat16)) -> int:
    """``rt::Dtype`` code of a torch dtype (float32 = 0, bfloat16 = 1,
    int8 = 2), refusing a dtype outside ``allowed`` (A operands and
    outputs are float32 or bfloat16; only an int8 B payload is int8)."""
    if dtype not in allowed:
        names = " or ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"expected {names}, got {dtype}")
    return DTYPE_CODES[dtype]


def b_layout(b) -> int:
    """1 when ``b`` (..., K, N) is the transpose of a row-major (..., N, K)
    stack, 0 when it is row-major itself; anything else is refused."""
    if b.is_contiguous():
        return 0
    if b.transpose(-1, -2).is_contiguous():
        return 1
    raise ValueError(f"B of shape {tuple(b.shape)} and strides {b.stride()}"
                     f" is neither row-major nor a transposed row-major "
                     f"matrix")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
