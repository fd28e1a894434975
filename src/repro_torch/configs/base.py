"""Model + shape configuration dataclasses and the arch registry.

The port's own copy of ``repro.configs.base`` (which imports no JAX, but
the port imports nothing of the JAX package): the same fields, the same
parameter counts, the same ten registered architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe", "audio", "vlm", "hybrid", "ssm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # Block pattern cycled over layers: attn | local | rglru | mlstm | slstm.
    block_pattern: tuple[str, ...] = ("attn",)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # MLA (use_mla => attention blocks are MLA)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # Recurrent / local
    local_window: int = 2048
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    # Positions
    pos_kind: Literal["rope", "mrope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] | None = None
    # Modality frontend stub: None = token ids; 'audio'/'vision' = the input
    # is precomputed frame/patch embeddings (B, S, d_model) per instructions.
    frontend: str | None = None
    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # True when every block is attention-free or windowed => O(1)-state
    # decode, eligible for the long_500k shape.
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_types(self) -> tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for t in self.layer_types:
            if t in ("attn", "local"):
                if self.use_mla:
                    qk = self.qk_nope_dim + self.qk_rope_dim
                    total += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
                    total += d * self.kv_lora_rank
                    total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    total += d * self.qk_rope_dim + self.n_heads * self.v_head_dim * d
                else:
                    total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                if self.n_experts:
                    total += d * self.n_experts + 3 * self.n_experts * d * ff
                elif ff:
                    total += 3 * d * ff
            elif t == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + 2 * w * w + w * d + (self.conv_width + 3) * w
                if ff:
                    total += 3 * d * ff
            elif t == "mlstm":
                di = 2 * d
                total += 2 * d * di + 3 * di * di + di * d
            elif t == "slstm":
                total += 4 * d * d + 4 * d * d // self.n_heads + int(4 / 3 * d) * 3 * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_total = self.param_count()
        moe_layers = sum(1 for t in self.layer_types if t in ("attn", "local"))
        all_experts = 3 * self.n_experts * d * ff * moe_layers
        active = 3 * self.top_k * d * ff * moe_layers
        return dense_total - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


LM_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells for an arch; long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


def _load_all() -> None:
    import importlib

    for mod in (
        "stablelm_3b",
        "llama3_2_1b",
        "minicpm3_4b",
        "deepseek_67b",
        "moonshot_v1_16b_a3b",
        "phi3_5_moe",
        "musicgen_large",
        "qwen2_vl_2b",
        "recurrentgemma_9b",
        "xlstm_350m",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
