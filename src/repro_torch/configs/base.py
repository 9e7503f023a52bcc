"""Architecture / shape configuration dataclasses and the registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of it).  Each ported architecture has one module in ``repro_torch.configs``
exporting ``CONFIG`` (the published dims) and ``smoke_config()`` (a reduced
config of the same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared: int = 0             # always-on shared experts
    top_k: int = 1
    expert_d_ff: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    first_dense_layers: int = 0   # leading layers that use a dense MLP instead

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0              # 0 = SSM disabled
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head dim (P)
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin/RecurrentGemma recurrent block config."""
    lru_width: int = 0
    d_conv: int = 4
    block_pattern: Sequence[str] = ()   # e.g. ("rec", "rec", "attn")

    @property
    def enabled(self) -> bool:
        return self.lru_width > 0


@dataclass(frozen=True)
class SparsityConfig:
    """Two-sided block-sparsity feature flags (FlexNN §III-D analogue)."""
    weight_sparsity: float = 0.0       # target magnitude-pruned fraction
    activation_threshold: float = 0.0  # |x| <= thr treated as zero
    block_m: int = 128
    block_k: int = 128

    @property
    def enabled(self) -> bool:
        return self.weight_sparsity > 0.0 or self.activation_threshold > 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU)
    rope: str = "full"          # full | half (chatglm 2d) | partial25 | mrope | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # gemma-style sqrt(d) scaling
    window: int = 0             # sliding attention window (0 = global)
    logit_softcap: float = 0.0
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    # encoder-decoder (whisper): n_layers applies to both stacks.
    encoder_decoder: bool = False
    # modality frontend stub: number of prefix embedding positions fed by
    # ``input_specs`` as precomputed patch/frame embeddings.
    frontend: str = "none"       # none | vision | audio
    attn_free: bool = False
    subquadratic: bool = False   # can run long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + stacks), for 6ND math."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.act in ("silu", "gelu"):      # gated MLPs: 3 matrices
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        per_layer = attn + mlp_dense
        total = 0
        n_layers = self.n_layers * (2 if self.encoder_decoder else 1)
        if self.moe.enabled:
            moe_mlp = 3 * d * self.moe.expert_d_ff * (self.moe.n_experts + self.moe.n_shared)
            router = d * self.moe.n_experts
            n_moe = self.n_layers - self.moe.first_dense_layers
            total += n_moe * (attn + moe_mlp + router)
            total += self.moe.first_dense_layers * per_layer
        elif self.ssm.enabled:
            d_in = self.ssm.expand * d
            per = 2 * d * d_in + d_in * d \
                + d_in * (2 * self.ssm.n_groups * self.ssm.d_state)
            total += self.n_layers * per
        elif self.rglru.enabled:
            w = self.rglru.lru_width
            rec = 2 * d * w + w * d + 3 * w  # in/gate proj + out proj + gates
            pat = self.rglru.block_pattern or ("rec",)
            attn_frac = pat.count("attn") / len(pat)
            total += int(self.n_layers * ((1 - attn_frac) * (rec + mlp_dense)
                                          + attn_frac * per_layer))
        else:
            total += n_layers * per_layer
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (= param_count for non-MoE)."""
        if not self.moe.enabled:
            return self.param_count()
        d = self.d_model
        attn = d * (self.n_heads * self.head_dim) \
            + 2 * d * (self.n_kv_heads * self.head_dim) \
            + (self.n_heads * self.head_dim) * d
        act_mlp = 3 * d * self.moe.expert_d_ff * (self.moe.top_k + self.moe.n_shared)
        router = d * self.moe.n_experts
        n_moe = self.n_layers - self.moe.first_dense_layers
        total = n_moe * (attn + act_mlp + router)
        total += self.moe.first_dense_layers * (attn + 3 * d * self.d_ff)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    # runtime knobs (per-cell overridable in configs.cells)
    n_micro: int = 1           # gradient-accumulation microbatches (train)
    remat: str = "full"        # none | dots | full
    loss_chunk: int = 512      # chunked-CE sequence chunk
    attn_chunk: int = 512      # online-softmax query-chunk for long seq
    grad_dtype: str = "f32"    # grad accumulation/reduction dtype (f32|bf16)


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


ARCH_IDS = [
    "stablelm-1.6b",
    "edge-tiny",
    "deepseek-moe-16b",
    "yi-9b",
    "gemma-2b",
    "chatglm3-6b",
    "recurrentgemma-9b",
    "mamba2-1.3b",
    "whisper-tiny",
    "qwen2-vl-72b",
    "llama4-scout-17b-a16e",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()



# ---------------------------------------------------------------------------
# Production cells (the dry-run and roofline grid)
# ---------------------------------------------------------------------------

# the reference's assigned architectures, in its order: the cell grid
# (``cells``) walks them so; ``ARCH_IDS`` above keeps the port's registry
# order and ``edge-tiny``, which has no production cell
CELL_ARCH_IDS = [
    "qwen2-vl-72b",
    "yi-9b",
    "gemma-2b",
    "chatglm3-6b",
    "stablelm-1.6b",
    "whisper-tiny",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "recurrentgemma-9b",
    "mamba2-1.3b",
]


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """Whether an (arch, shape) cell is runnable: ``long_500k`` only for a
    sub-quadratic architecture."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def cells(include_skipped: bool = False):
    """Yield every assigned (arch_id, shape_name) cell, in the reference's
    order."""
    for a in CELL_ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if include_skipped or shape_applicable(cfg, s):
                yield a, s.name


def scaled_shape(shape: ShapeConfig, *, seq: Optional[int] = None,
                 batch: Optional[int] = None, **kw) -> ShapeConfig:
    return dataclasses.replace(shape, seq_len=seq or shape.seq_len,
                               global_batch=batch or shape.global_batch, **kw)
