"""Per-cell step builders shared by the dry-run and the roofline, the
reference's ``launch/step_builders.py``.

For one (arch × shape × mesh) cell this module builds what a trace of one
rank's step needs:

    fn        the step function (train / prefill / decode) on this rank's
              shards, under the cell's rules and execution config
    args      meta tensors (shapes and dtypes, no storage) of this rank's
              block of every input — parameters, optimizer state, batch,
              decode state — as the reference's ``in_shardings`` cut them

The sharding flows from ``sharding.partition``'s rules; the per-cell
flags (SP cache sharding, FSDP on or off) and knobs come from
``configs.cells``.

``trace_cell`` stands in for the reference's ``lower_cell``: XLA lowers
and compiles the reference's step against ``ShapeDtypeStruct``s; the
port runs one rank's step eagerly on fake tensors (``FakeTensorMode``),
over whatever process group is initialised (a fake one of the mesh's
size for the dry-run, ``launch.dryrun``), and reads what it did: the
live bytes (``roofline.memory.MemoryTracker``), the FLOPs
(``FlopCounterMode`` plus the kernel wrappers' counters,
``kernels.accounting``), the bytes every operator reads and writes and
the collectives (``sharding.collectives.counting``).  Nothing is
allocated and no card is needed.  The same ``fn`` runs for real on real
inputs of those shapes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs.base import ArchConfig, ShapeConfig, get_config
from repro_torch.configs.cells import (CellFlags, cell_flags, cell_shape,
                                       clamp_micro)
from repro_torch.core.scheduler import H100
from repro_torch.kernels import accounting, ops
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_lib
from repro_torch.roofline.memory import MemoryTracker
from repro_torch.sharding import collectives, partition
from repro_torch.sharding.partition import Rules, make_rules
from repro_torch.train.optimizer import AdamWConfig, OptState, init_opt_state


@dataclass
class CellStep:
    name: str
    fn: Callable
    args: Tuple            # meta tensors: this rank's blocks
    rules: Rules
    shape: ShapeConfig
    cfg: ArchConfig
    flags: CellFlags
    exec_cfg: Optional[ops.ExecConfig]


def dp_size(mesh: Mesh) -> int:
    dp = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        dp *= mesh.shape["pod"]
    return dp


def params_abstract(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameter tree as meta tensors (``model.param_shapes``: the
    init's shapes and dtypes, nothing drawn)."""
    return model_lib.param_shapes(cfg, dtype=dtype)


def opt_abstract(params) -> OptState:
    return init_opt_state(params)


def build_rules(cfg: ArchConfig, mesh: Mesh, kind: str,
                flags: CellFlags) -> Rules:
    return make_rules(mesh, kind=kind, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, seq_shard=flags.seq_shard,
                      fsdp=flags.fsdp)


def _local(tree, specs, mesh: Mesh):
    """Meta tensors of this rank's blocks of ``tree``'s leaves."""
    if isinstance(tree, dict):
        return {k: _local(v, specs[k], mesh) for k, v in tree.items()}
    return torch.empty(partition.local_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype, device="meta")


def build_cell_step(arch_id: str, shape_name: str, mesh: Mesh, *,
                    cfg: Optional[ArchConfig] = None,
                    shape: Optional[ShapeConfig] = None,
                    flags: Optional[CellFlags] = None,
                    opt_cfg: Optional[AdamWConfig] = None,
                    dtype=torch.bfloat16,
                    exec_cfg: Any = "card") -> CellStep:
    """The step of one (arch × shape × mesh) cell on this rank's shards.

    Train: ``build_train_step(cfg, shape, opt, mesh, rules)`` after
    ``clamp_micro``, taking this rank's batch rows; prefill:
    ``model.prefill`` under the rules; decode: ``build_serve_step`` under
    them, its caches cut as ``batch_shardings`` places them.  ``exec_cfg``
    ``"card"`` (the default) runs the kernels under the descriptor table
    selected for the H100 at one tensor-parallel rank's shapes, None the
    plain PyTorch path; or pass an ``ExecConfig``."""
    from repro_torch.serve.engine import build_serve_step, shape_exec_config
    from repro_torch.train.train_step import build_train_step, param_specs

    cfg = cfg or get_config(arch_id)
    shape = shape or cell_shape(arch_id, shape_name)
    flags = flags or cell_flags(arch_id, shape_name)
    if shape.kind == "train":
        shape = clamp_micro(shape, dp_size(mesh))
    rules = build_rules(cfg, mesh, shape.kind, flags)
    if exec_cfg == "card":
        exec_cfg = shape_exec_config(
            cfg, shape, model_shards=mesh.shape.get("model", 1),
            use_kernels=True, hw=H100, device="cpu")
    ec = exec_cfg

    p_meta = params_abstract(cfg, dtype)
    p_specs = param_specs(cfg, rules)
    specs_in = model_lib.input_specs(cfg, shape, dtype=dtype)
    b_specs = partition.batch_shardings(specs_in, mesh,
                                        seq_shard=flags.seq_shard)
    p_loc = _local(p_meta, p_specs, mesh)
    name = f"{arch_id}@{shape_name}"

    def run(fn, *args):
        if ec is None:
            return fn(*args)
        with ops.exec_config(ec):
            return fn(*args)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        o_meta = opt_abstract(p_meta)
        o_loc = OptState(step=o_meta.step, mu=_local(o_meta.mu, p_specs, mesh),
                         nu=_local(o_meta.nu, p_specs, mesh))
        raw = build_train_step(cfg, shape, opt_cfg, mesh, rules,
                               batch_specs=b_specs)

        def fn(params, opt_state, batch):
            return run(raw, params, opt_state, batch)

        return CellStep(name, fn, (p_loc, o_loc,
                                   _local(specs_in, b_specs, mesh)),
                        rules, shape, cfg, flags, ec)

    batch_axis = b_specs["frames" if "frames" in b_specs else "tokens"][0]
    if shape.kind == "prefill":
        def fn(params, batch):
            with partition.use_rules(rules, p_specs, batch_axis):
                return run(lambda: model_lib.prefill(
                    params, cfg, batch, q_chunk=shape.attn_chunk))

        return CellStep(name, fn, (p_loc, _local(specs_in, b_specs, mesh)),
                        rules, shape, cfg, flags, ec)

    serve = build_serve_step(cfg)
    cache = partition.cache_axis(b_specs["state"])

    def fn(params, tokens, state, pos):
        with partition.use_rules(rules, p_specs, batch_axis, cache):
            return run(serve, params, tokens, state, pos)

    loc = _local(specs_in, b_specs, mesh)
    return CellStep(name, fn, (p_loc, loc["tokens"], loc["state"],
                               loc["pos"]), rules, shape, cfg, flags, ec)


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "silu",
                   "gelu", "softplus", "_softmax", "_log_softmax",
                   "logsumexp", "pow"}


# gathers read only the rows they return, scatters write only the rows
# they are given: their source / destination counts no further
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put", "index_add", "index_copy", "scatter",
             "scatter_add", "masked_scatter"}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpBytes(TorchDispatchMode):
    """Per operator: the bytes of its tensor inputs and outputs (views
    move nothing and count nothing, nor do ``empty`` and the metadata
    queries of the ``prim`` namespace; a gather counts its indices and
    what it returns, a scatter its indices and values read and its values
    written, not the whole tensor it indexes) and the elements of its
    transcendental results."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.transcendentals = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _GATHERS:
            self.bytes += _tensor_bytes((args[1:], kwargs, out))
        elif name in _SCATTERS:       # reads its inputs, writes its values
            values = [t for t in tree_leaves(args[1:])
                      if isinstance(t, torch.Tensor)][-1:]
            self.bytes += _tensor_bytes((args[1:], kwargs, values))
        elif (func.namespace != "prim" and not func.is_view
                and not name.startswith("empty")):
            self.bytes += _tensor_bytes((args, kwargs, out))
        if name in _TRANSCENDENTAL:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.transcendentals += t.numel()
        return out


def trace_device() -> str:
    """Fake CUDA tensors where PyTorch has CUDA; else fake CPU ones that
    take the card's route (``accounting.card_route``)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _fake_like(tree, device):
    def make(t):
        if isinstance(t, torch.Tensor):
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        return t
    return tree_map(make, tree)


def trace_cell(step: CellStep, *, device: Optional[str] = None
               ) -> Dict[str, Any]:
    """One rank's step on fake tensors: {memory {argument_bytes,
    output_bytes, peak_bytes, temp_bytes}, flops, kernel_flops,
    bytes (operators' inputs and outputs plus the kernels' counted bytes:
    an upper bound on device-memory traffic), transcendentals,
    collectives (``CollectiveSummary``), seconds}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    device = device or trace_device()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        args = _fake_like(step.args, device)
    accounting.reset()
    t0 = time.perf_counter()
    with mode, accounting.card_route(), collectives.counting() as coll, \
            FlopCounterMode(display=False) as fc, OpBytes() as ob, \
            MemoryTracker() as mt:
        arg_bytes = mt.add_args(args)
        out = step.fn(*args)
        out_bytes = mt.outputs(out)
        del out
    seconds = time.perf_counter() - t0
    kern = accounting.totals()
    flops = float(fc.get_total_flops()) + kern["flops"]
    return {
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "peak_bytes": int(mt.peak),
                   "temp_bytes": int(max(mt.peak - mt._round(arg_bytes),
                                         0))},
        "flops": flops,
        "kernel_flops": kern["flops"],
        "kernel_calls": int(kern["calls"]),
        "bytes": ob.bytes + kern["bytes"],
        "transcendentals": ob.transcendentals,
        "collectives": coll,
        "seconds": seconds,
    }
