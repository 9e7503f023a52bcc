"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP), the reference's
``sharding/partition.py`` on ``torch.distributed``.

The rules are the reference's: ``make_rules`` maps logical axis names to
mesh axes and parameter paths to specs, ``partition_params`` gives every
leaf its spec after ``_sanitize`` (axes that do not divide the dim are
dropped), ``batch_shardings`` every model input and decode-state leaf its
own.  A spec is a tuple with one entry per dim: None, a mesh axis name,
or a tuple of them (the reference's ``PartitionSpec`` entries), and the
specs equal the reference's leaf for leaf.

GSPMD places the reference's tensors; the port places them itself:
``shard_leaf`` is this rank's block of a leaf under its spec and
``gather_leaf`` (collective) its inverse.  One layout differs from a plain
block split: ``attn.wkv`` is laid out ``[K heads | V heads]``, and a split
of its columns over ``model`` takes this rank's block of each half, so a
rank holds the K and the V columns of the same kv heads; ``gather_leaf``
puts the halves back, so gathered trees and checkpoints keep the
reference's layout.

Under ``use_rules(rules, specs)`` the model runs on local shards: each
layer gathers its FSDP dims (every mesh axis but ``model``) as it starts
(``fsdp_gathered``), and ``tensor_parallel`` tells the layers how many
``model`` shards their heads, MLP columns and vocabulary rows are split
into.  ``shard`` — the reference's sharding constraint — changes nothing
in the port: its tensors are already local.

The stored blocks are the reference's specs' (so checkpoints, gathers and
the global grad norm see plain block splits).  A layer asks the installed
specs how each of its leaves is stored (``model_dim``: ``fsdp_gathered``
installs the running layer's specs) and takes its share through one of
three helpers: ``model_block`` (this rank's block of a dim: the stored
block where the leaf is so split), ``model_whole`` (the whole leaf) and
``model_columns`` (any ascending set of columns per rank, fetched from
their owners: the SSM's packed ``in_proj`` [z | x | B C | dt], whose
blocks cross the packing).  Where the share is not the stored block —
the RG-LRU's ``conv_w``, stored split over its 4 taps; a leaf the rules
keep replicated over ``model`` but each rank uses a slice of; columns
that every rank uses — each rank's use is a partial one, and the
backward of the collective that brought the leaf sums the gradient over
``model``: all-gather → reduce-scatter, replicated → all-reduce, fetched
columns → summed at their owner.  The leaves so summed:

  ``moe.router`` (expert parallelism: each rank routes its own tokens);
  ``ssm.in_proj`` (B and C columns used whole on every rank),
  ``ssm.conv_w`` / ``ssm.conv_b`` (the B and C channels),
  ``ssm.norm_scale``;
  ``rglru.conv_w``, ``rglru.w_a``, ``rglru.w_i``, ``rglru.b_i``,
  ``rglru.lam`` (each rank's channel columns).

The sum lives in the graph, not in a list the step applies afterwards:
the same router is used replicated — its gradient whole on every rank —
when expert parallelism does not apply (``moe.apply_moe``).

``use_rules`` also installs the batch axes the step cut its inputs over
(``batch_rows``): the MoE's choice of expert parallelism depends on the
global batch, of which a layer sees only its rows.
"""
from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import collectives

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


@dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axis (or tuple), plus param path rules."""
    logical: Dict[str, MeshAxes]
    # (regex over param path, spec) — first match wins
    params: Tuple[Tuple[str, Spec], ...]
    mesh: Optional[Mesh] = None

    def axis(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.logical.get(name)

    def spec(self, *logical_axes: Optional[str]) -> Spec:
        return tuple(self.axis(a) for a in logical_axes)


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: Spec


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


def current_specs():
    """The parameter spec tree installed with the rules (None without)."""
    return getattr(_state, "specs", None)


def batch_rows() -> MeshAxes:
    """The mesh axes the installed step cut its inputs' batch dim over
    (``batch_shardings``' spec of the tokens); None where every rank holds
    the whole batch."""
    return getattr(_state, "batch", None)


def cache_rows() -> MeshAxes:
    """The mesh axis the installed decode step's KV caches (and a
    cross-attention's memory) cut their rows over (``batch_shardings``'
    ``cache_seq``: "model" under SP), None where each rank holds every
    row."""
    return getattr(_state, "cache", None)


def installed():
    """What ``use_rules`` installed, as its arguments: (rules, specs,
    batch, cache)."""
    return current_rules(), current_specs(), batch_rows(), cache_rows()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], specs=None, batch: MeshAxes = None,
              cache: MeshAxes = None):
    """Install ``rules`` and, for a step on local shards, the spec tree of
    the parameters (``partition_params``) the model gathers by, the axes
    its batch rows are cut over and, for a decode step, the axis its
    caches' rows are cut over (``cache_rows``)."""
    prev = installed()
    _state.rules, _state.specs, _state.batch, _state.cache = (
        rules, specs, batch, cache)
    try:
        yield rules
    finally:
        (_state.rules, _state.specs, _state.batch,
         _state.cache) = prev


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint: ``x`` itself.  A port tensor is
    already this rank's block, placed by the step that owns it."""
    return x


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

def _batch_axes(mesh: Mesh) -> MeshAxes:
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _div(n: int, mesh: Mesh, axis: str = "model") -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def make_rules(mesh: Mesh, *, kind: str, n_heads: int, n_kv_heads: int,
               seq_shard: bool = False, fsdp: bool = True) -> Rules:
    """The rule set of one (arch, shape-kind, mesh) combination.

    kind:        train | prefill | decode
    seq_shard:   SP — shard the KV-cache/sequence dim over "model".
    fsdp:        shard the parameter "embed" (d_model) dim over the batch
                 axes (reduce-scatter/all-gather FSDP).
    """
    batch = _batch_axes(mesh)
    heads = "model" if _div(n_heads, mesh) else None
    kv_heads = "model" if _div(n_kv_heads, mesh) else None
    fsdp_axis: MeshAxes = batch if fsdp else None

    logical: Dict[str, MeshAxes] = {
        "batch": batch,
        "seq": "model" if seq_shard else None,
        "embed": None,                 # activation d_model stays unsharded
        "heads": heads,
        "kv_heads": kv_heads,
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "expert": "model",
        "param_embed": fsdp_axis,      # FSDP dim on weights
        "param_ffn": "model",          # TP dim on weights
        "param_vocab": "model",
        "param_heads": "model",
        "cache_seq": "model" if seq_shard else None,
        "cache_batch": batch,
    }

    params: Tuple[Tuple[str, Spec], ...] = (
        # embeddings / lm head: vocab over model (chunked-CE), FSDP on d
        (r".*(embed|lm_head|emb)$", ("model", fsdp_axis)),
        # attention projections: (d_model, heads*hd) / out: (heads*hd, d)
        (r".*attn.*(wq|wkv|wk|wv)$", (fsdp_axis, "model")),
        (r".*attn.*wo$", ("model", fsdp_axis)),
        # dense MLP: in (d, ff) / out (ff, d)
        (r".*(mlp|ffn).*(w_in|w_gate)$", (fsdp_axis, "model")),
        (r".*(mlp|ffn).*w_out$", ("model", fsdp_axis)),
        # MoE experts: (E, d, ff)-style — experts over model (EP)
        (r".*experts.*", ("model", fsdp_axis, None)),
        (r".*router.*", (fsdp_axis, None)),
        (r".*shared.*w_(in|gate)$", (fsdp_axis, "model")),
        (r".*shared.*w_out$", ("model", fsdp_axis)),
        # SSM / RG-LRU: channel-parallel over model
        (r".*(ssm|rglru).*(in_proj|w_x|w_gate|in)$", (fsdp_axis, "model")),
        (r".*(ssm|rglru).*(out_proj|w_out|out)$", ("model", fsdp_axis)),
        (r".*(ssm|rglru).*(conv|dt_bias|A_log|D|lambda|b_a|b_x).*",
         ("model",)),
        (r".*(norm|ln|scale|bias).*", ()),          # replicated small
        (r".*", ()),                                # default: replicated
    )
    return Rules(logical=logical, params=params, mesh=mesh)


def leading_stack_dim(spec: Spec) -> Spec:
    """Prefix a spec with None for the stacked layer dim."""
    return (None,) + tuple(spec)


def param_spec(path: str, rules: Rules, stacked: bool) -> Spec:
    for pat, spec in rules.params:
        if re.match(pat, path):
            return leading_stack_dim(spec) if stacked else spec
    return ()


def tree_paths(tree, prefix: str = "") -> Dict[str, object]:
    """path ("stack/layers/attn/wq") -> leaf of a nested dict, in the
    reference's (sorted-key) order; a spec tuple is a leaf."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


STACKED_SEGMENTS = ("layers", "blocks", "encoder", "decoder", "groups",
                    "trailing", "dense_layers")


def partition_params(params_shapes, rules: Rules,
                     stacked_prefixes: Sequence[str] = STACKED_SEGMENTS):
    """A tree of leaves with ``.shape`` -> the same tree of specs.

    A leaf is *stacked* (carries a leading layer dim) when any non-leaf
    segment of its path is a stacked-collection name."""
    def assign(path, leaf):
        shape = tuple(leaf.shape)
        stacked = any(seg in stacked_prefixes
                      for seg in path.split("/")[:-1]) and len(shape) >= 1
        spec = param_spec(path, rules, stacked)
        return _sanitize(spec, shape, rules.mesh)
    return _map_paths(assign, params_shapes)


def _axis_size(mesh: Mesh, ax: MeshAxes) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def _sanitize(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    axes = list(spec) + [None] * (len(shape) - len(spec))
    axes = axes[:len(shape)]
    return tuple(ax if ax is not None and dim % _axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, axes))


def named(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, tuple(axes))


# ---------------------------------------------------------------------------
# Batch-input and decode-state shardings
# ---------------------------------------------------------------------------

# model-input name -> logical spec ("batch" resolved per mesh)
_BATCH_INPUT_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "vis_embeds": ("batch", None, None),
    "frames": ("batch", None, None),
    "mrope_positions": (None, "batch", None),
    "pos": (),
}

# decode-state param-path patterns (leading layer-stack dim prepended):
#   kv caches   (B, C, KVH, hd) : batch, cache_seq, -, -
#   ssm state   (B, H, P, N)    : batch, model(heads), -, -
#   conv state  (B, K-1, C)     : batch, -, model(channels)
#   rglru h     (B, W)          : batch, model
_STATE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*(memory|self|layers|groups|trailing).*/(k|v)$",
     ("batch", "cache_seq", None, None)),
    (r".*ssm$", ("batch", "heads", None, None)),
    (r".*conv$", ("batch", None, "ffn")),
    (r".*/h$", ("batch", "ffn")),
)


def batch_shardings(specs, mesh: Mesh, *, seq_shard: bool = False):
    """Specs for a model-input dict (incl. nested decode state): a tree of
    leaves with ``.shape`` -> the same tree of specs."""
    batch = _batch_axes(mesh)
    logical = {"batch": batch,
               "cache_seq": "model" if seq_shard else None,
               "heads": "model", "ffn": "model"}

    def resolve(axes, shape):
        mesh_axes = tuple(logical.get(a, None) if isinstance(a, str) else None
                          for a in axes)
        return _sanitize(mesh_axes, shape, mesh)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        top = path.split("/")[0]
        if top in _BATCH_INPUT_AXES:
            return resolve(_BATCH_INPUT_AXES[top], shape)
        for pat, axes in _STATE_RULES:
            if re.match(pat, path):
                # decode states carry a leading stacked-layer dim
                full = (None,) + axes if len(axes) < len(shape) else axes
                return resolve(full, shape)
        return resolve((), shape)
    return _map_paths(assign, specs)


def cache_axis(state_specs) -> MeshAxes:
    """The mesh axis the KV caches of a decode state's specs
    (``batch_shardings``) cut their rows over — the row dim of every k / v
    leaf (L, B, C, KVH, hd) — or None; caches cut differently raise."""
    axes = {spec[2] for path, spec in tree_paths(state_specs).items()
            if path.split("/")[-1] in ("k", "v")}
    if len(axes) > 1:
        raise NotImplementedError(
            f"decode caches cut over {sorted(map(str, axes))}")
    return axes.pop() if axes else None


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _axis_size(mesh, ax) for d, ax in zip(shape, spec))


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------

def _halved(path: str, spec: Spec) -> bool:
    """A ``wkv`` whose columns are split over ``model``: each half (K, V)
    is split on its own."""
    return (path.split("/")[-1] == "wkv" and len(spec) > 0
            and spec[-1] == "model")


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh, *, path: str = "",
               rank: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the full leaf ``x`` under ``spec`` (``rank``:
    another rank's, on any mesh): ``x`` itself where no dim is split,
    else a new contiguous tensor."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if all(_axis_size(mesh, ax) == 1 for ax in spec):
        return x
    if _halved(path, spec):
        n = x.shape[-1]
        if (n // 2) % mesh.shape["model"]:
            raise ValueError(f"{path}: halves of {n} columns do not split "
                             f"over {mesh.shape['model']} model shards")
        halves = shard_leaf(x.unflatten(-1, (2, n // 2)), spec[:-1]
                            + (None, "model"), mesh, rank=rank)
        return halves.flatten(-2)
    for dim, ax in enumerate(spec):
        n = _axis_size(mesh, ax)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"{path or 'leaf'}: dim {dim} of "
                                 f"{tuple(x.shape)} over {n} ranks")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(ax, rank) * size, size)
    return x.contiguous().clone()


def assemble_leaf(pieces: Sequence[torch.Tensor], spec: Spec, mesh: Mesh, *,
                  path: str = "") -> torch.Tensor:
    """The full leaf from every rank's block (``pieces[rank]``), the
    inverse of ``shard_leaf``."""
    x = pieces[0]
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if all(_axis_size(mesh, ax) == 1 for ax in spec):
        return x
    if _halved(path, spec):
        halves = [p.unflatten(-1, (2, p.shape[-1] // 2)) for p in pieces]
        return assemble_leaf(halves, spec[:-1] + (None, "model"),
                             mesh).flatten(-2)
    shape = [d * _axis_size(mesh, ax) for d, ax in zip(x.shape, spec)]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for rank, piece in enumerate(pieces):
        view = out
        for dim, ax in enumerate(spec):
            if _axis_size(mesh, ax) > 1:
                view = view.narrow(dim, mesh.axis_index(ax, rank)
                                   * piece.shape[dim], piece.shape[dim])
        view.copy_(piece)
    return out


def gather_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh, *,
                path: str = "") -> torch.Tensor:
    """The full leaf from this rank's block ``x`` (every rank of the mesh
    calls it: one all-gather over the world)."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if all(_axis_size(mesh, ax) == 1 for ax in spec):
        return x
    flat = collectives.gather_dim(x.contiguous().reshape(1, -1),
                                  mesh.group(mesh.axis_names), 0)
    pieces = [p.reshape(x.shape) for p in flat]
    return assemble_leaf(pieces, spec, mesh, path=path)


def shard_tree(tree, specs, mesh: Mesh):
    """``shard_leaf`` over a nested dict (``specs``: the same dict)."""
    return _map_paths(lambda path, x: shard_leaf(
        x, _at(specs, path), mesh, path=path), tree)


def gather_tree(tree, specs, mesh: Mesh):
    """``gather_leaf`` over a nested dict, leaf by leaf in sorted order."""
    paths = tree_paths(tree)
    full = {p: gather_leaf(x, _at(specs, p), mesh, path=p)
            for p, x in paths.items()}
    return _map_paths(lambda path, _: full[path], tree)


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# The model on local shards
# ---------------------------------------------------------------------------

class TensorParallel(NamedTuple):
    """The ``model`` axis the layers split over: its size, this rank's
    index on it and its process group."""
    size: int
    index: int
    group: object


def tensor_parallel() -> Optional[TensorParallel]:
    """The model axis of the installed rules when it is above 1, else
    None (the unsharded arithmetic)."""
    rules = current_rules()
    if (rules is None or rules.mesh is None or current_specs() is None
            or rules.mesh.shape.get("model", 1) <= 1):
        return None
    mesh = rules.mesh
    return TensorParallel(mesh.shape["model"], mesh.axis_index("model"),
                          mesh.group("model"))


def _fsdp_gather(tree, specs, mesh: Mesh):
    """Every dim of ``tree``'s leaves split over axes other than ``model``
    gathered (autograd: the backward reduce-scatters the gradient)."""
    if isinstance(tree, dict):
        return {k: _fsdp_gather(v, specs[k], mesh) for k, v in tree.items()}
    for dim, ax in enumerate(specs):
        if ax is not None and ax != "model":
            tree = collectives.all_gather(tree, mesh.group(ax), dim)
    return tree


def fsdp_gathered(fn, specs):
    """``fn(layer_params, ...)`` that first gathers the FSDP dims of its
    layer's parameters under ``specs`` (the layer's own: no stacked dim);
    ``fn`` itself without installed rules.  Inside a remat segment the
    backward gathers again."""
    rules = current_rules()
    if specs is None or rules is None or rules.mesh is None:
        return fn
    mesh = rules.mesh

    def run(lp, *args, **kw):
        lp = _fsdp_gather(lp, specs, mesh)
        prev = getattr(_state, "layer", None)
        _state.layer = {}
        _index_dicts(lp, specs, _state.layer)
        try:
            return fn(lp, *args, **kw)
        finally:
            _state.layer = prev
    return run


def _index_dicts(tree, specs, out: Dict[int, object]) -> None:
    """Every dict of a layer's gathered parameters → its spec tree, for
    ``model_dim`` while the layer runs."""
    if isinstance(tree, dict):
        out[id(tree)] = specs
        for k, v in tree.items():
            _index_dicts(v, specs[k], out)


def gather_top(params):
    """The parameters with their non-stack leaves (embed, lm_head,
    final_norm) FSDP-gathered under the installed specs; ``params`` itself
    without them."""
    rules, specs = current_rules(), current_specs()
    if specs is None or rules is None or rules.mesh is None:
        return params
    return {k: (v if k == "stack" else _fsdp_gather(v, specs[k], rules.mesh))
            for k, v in params.items()}


def stack_specs(group: str):
    """The per-layer specs of the stack's ``group`` (its leading stacked
    dim dropped); None without installed specs."""
    specs = current_specs()
    if specs is None:
        return None

    def drop(t):
        if isinstance(t, dict):
            return {k: drop(v) for k, v in t.items()}
        return t[1:]
    return drop(specs["stack"][group])


def model_gather(x: torch.Tensor, tp: TensorParallel,
                 halves: bool = False) -> torch.Tensor:
    """The columns of ``x`` split over ``model`` gathered (autograd), in
    the full leaf's layout (``halves``: a ``wkv``'s K / V halves)."""
    full = collectives.all_gather(x, tp.group, -1)
    if not halves:
        return full
    c = x.shape[-1] // 2
    return full.unflatten(-1, (tp.size, 2, c)).transpose(-3, -2).flatten(-3)


def model_dim(p, name: str) -> Optional[int]:
    """The dim of the leaf ``p[name]`` stored split over ``model`` under
    the installed specs (``p``: a dict of the parameters of the layer that
    ``fsdp_gathered`` runs), None where the leaf is whole on every model
    rank."""
    layer = getattr(_state, "layer", None) or {}
    if id(p) not in layer:
        raise ValueError(f"{name}: not a leaf of a layer running under "
                         f"fsdp_gathered with installed specs")
    for dim, ax in enumerate(layer[id(p)][name]):
        if ax == "model":
            return dim
    return None


def model_whole(p, name: str, tp: TensorParallel) -> torch.Tensor:
    """The whole leaf ``p[name]`` on every model rank, for a use of part
    of it on each: gathered from the ranks' blocks (backward: reduce-
    scatter), or the replicated leaf through ``to_model`` (backward:
    all-reduce) — the ranks' partial gradients summed either way."""
    dim = model_dim(p, name)
    if dim is None:
        return collectives.to_model(p[name], tp.group)
    return collectives.all_gather(p[name], tp.group, dim)


def model_replicated(p, name: str, tp: TensorParallel) -> torch.Tensor:
    """The whole leaf ``p[name]`` for a use that is the same on every
    model rank (each runs the whole computation, as where a layer's heads
    do not split over ``model``): gathered where it is stored split over
    ``model`` — a ``wkv`` back in its [K | V] layout — with this rank's
    block of the gradient taken back (``collectives.sp_out``), else the
    leaf itself."""
    x = p[name]
    dim = model_dim(p, name)
    if dim is None:
        return x
    full = collectives.sp_out(x, tp.group, dim)
    if name == "wkv" and dim == x.dim() - 1:
        c = x.shape[-1] // 2
        full = full.unflatten(-1, (tp.size, 2, c)).transpose(
            -3, -2).flatten(-3)
    return full


def model_block(p, name: str, tp: TensorParallel, dim: int) -> torch.Tensor:
    """This rank's block of the leaf ``p[name]`` along ``dim``: the stored
    block where the leaf is split so, else cut from ``model_whole``."""
    x = p[name]
    if model_dim(p, name) == dim % x.dim():
        return x
    n = x.shape[dim] // tp.size
    return model_whole(p, name, tp).narrow(dim, tp.index * n, n)


def model_columns(p, name: str, tp: TensorParallel, cols) -> torch.Tensor:
    """The columns ``cols(r)`` (ascending indices into the whole leaf's
    last dim) of ``p[name]`` that model rank r uses, on this rank: fetched
    from their owners where the leaf's columns are stored split over
    ``model`` (``collectives.fetch_columns``: no rank gathers the whole
    leaf), else cut from the whole leaf."""
    x = p[name]
    if model_dim(p, name) == x.dim() - 1:
        return collectives.fetch_columns(
            x, tp.group, [cols(r) for r in range(tp.size)])
    idx = torch.as_tensor(cols(tp.index), device=x.device)
    return model_whole(p, name, tp).index_select(-1, idx)
