"""Model configuration dataclasses and the architecture registry (port of
``repro.configs.base``).

Every architecture the JAX package registers is here, each in its own
module with ``config()`` (the published widths) and ``reduced_config()``
(the smoke-test size).  The paper's own models carry their configurations
in their modules (``ResNetConfig`` in :mod:`repro_torch.models.resnet`,
``LSTMConfig`` in :mod:`repro_torch.models.lstm`), as the JAX package's do.
``decode_window`` and ``gqa_grouped_decode`` are carried for the decode
path, which waits for ROADMAP queue A, item 15 (its decode half).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    """One layer inside a period group: a sequence mixer + a feed-forward."""

    mixer: str  # "attn" | "mamba"
    ffn: str    # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    source: str = ""                    # citation for the config

    # period structure: the model is num_layers/len(slots) repetitions of slots
    slots: Tuple[LayerSlot, ...] = (LayerSlot("attn", "dense"),)

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # attention details
    qk_norm: bool = False
    rope_theta: float = 500000.0
    sliding_window: int = 0             # 0 = full attention (training/prefill)
    decode_window: int = 0              # 0 = full KV cache in decode
    tp_local_kv: bool = False           # kv heads split over the model axis
    #   when they divide evenly (no K/V all-gather); see models/attention.py
    gqa_grouped_decode: bool = False    # grouped-query decode einsum

    # modality frontend stub (audio/vlm): precomputed embeddings in
    frontend: Optional[str] = None      # None | "audio" | "vision"
    frontend_dim: int = 0

    dtype: str = "float32"

    @property
    def period(self) -> int:
        return len(self.slots)

    @property
    def num_periods(self) -> int:
        if self.num_layers % self.period:
            raise ValueError(f"{self.name}: {self.num_layers} layers do not "
                             f"split into periods of {self.period}")
        return self.num_layers // self.period

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head; norms,
        Mamba-2's per-head vectors and conv filter, and a vision frontend's
        projection excluded, as the JAX package counts)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = 2 * self.vocab_size * d  # embed + head
        per_period = 0
        for s in self.slots:
            if s.mixer == "attn":
                per_period += d * self.num_heads * hd            # wq
                per_period += 2 * d * self.num_kv_heads * hd     # wk, wv
                per_period += self.num_heads * hd * d            # wo
            elif s.mixer == "mamba":
                di, n = self.ssm_d_inner, self.ssm_state
                g = 1
                per_period += d * (2 * di + 2 * g * n + self.ssm_heads)  # in_proj
                per_period += di * d                                     # out_proj
            if s.ffn == "dense":
                per_period += 3 * d * self.d_ff
            elif s.ffn == "moe":
                per_period += 3 * d * self.d_ff * self.moe_num_experts
                per_period += d * self.moe_num_experts
        return total + per_period * self.num_periods

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k experts only)."""
        if not self.moe_num_experts:
            return self.param_count()
        d = self.d_model
        dense_moe_delta = 3 * d * self.d_ff * (self.moe_num_experts - self.moe_top_k)
        n_moe_layers = sum(1 for s in self.slots if s.ffn == "moe") * self.num_periods
        return self.param_count() - dense_moe_delta * n_moe_layers


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


ARCH_IDS = [
    "llama3_8b",
    "mamba2_1p3b",
    "jamba_v01_52b",
    "musicgen_medium",
    "llava_next_34b",
    "qwen3_moe_30b_a3b",
    "codeqwen15_7b",
    "olmoe_1b_7b",
    "qwen3_4b",
    "yi_6b",
]

# CLI aliases with the assignment's original ids
ARCH_ALIASES = {
    "llama3-8b": "llama3_8b",
    "mamba2-1.3b": "mamba2_1p3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "musicgen-medium": "musicgen_medium",
    "llava-next-34b": "llava_next_34b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-4b": "qwen3_4b",
    "yi-6b": "yi_6b",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced_config() if reduced else mod.config()
