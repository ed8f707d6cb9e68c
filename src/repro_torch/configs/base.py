"""Model configuration dataclasses and the architecture registry (port of
``repro.configs.base``, the fields the dense training path reads).

Only the dense attention + SwiGLU architecture is ported (``llama3_8b``);
the other registered architectures wait for the second half of ROADMAP
queue A, item 15.  Its first half brought the paper's own models, which
carry their configurations in their modules (``ResNetConfig`` in
:mod:`repro_torch.models.resnet`, ``LSTMConfig`` in
:mod:`repro_torch.models.lstm`), as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    """One layer inside a period group: a sequence mixer + a feed-forward."""

    mixer: str  # "attn"
    ffn: str    # "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense
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
    rope_theta: float = 500000.0
    dtype: str = "float32"
    tp_local_kv: bool = False           # kv heads split over the model axis
    #   when they divide evenly (no K/V all-gather); see models/attention.py

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

    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def param_count(self) -> int:
        """Parameter count of the dense model (embeddings + blocks + head,
        norms excluded)."""
        d, hd = self.d_model, self.resolved_head_dim
        per_layer = (2 * d * self.num_heads * hd              # wq, wo
                     + 2 * d * self.num_kv_heads * hd         # wk, wv
                     + 3 * d * self.d_ff)                     # gate, up, down
        return 2 * self.vocab_size * d + per_layer * self.num_layers


ARCH_IDS = ["llama3_8b"]
ARCH_ALIASES = {"llama3-8b": "llama3_8b"}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    arch = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ROADMAP queue A, "
            f"item 15); ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced_config() if reduced else mod.config()
