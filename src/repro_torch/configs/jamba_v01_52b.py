"""Jamba-v0.1 (52B total) — hybrid Mamba+attention 1:7 interleave with MoE
on every other FFN, 16 experts top-2 [arXiv:2403.19887].

Note: Jamba uses Mamba-1 internally (ssm_state=16); we model the mixer with
our SSD layer at the same state size, as the JAX package does.
"""

from repro_torch.configs.base import LayerSlot, ModelConfig


def _slots(period: int, attn_at: int):
    return tuple(
        LayerSlot("attn" if i == attn_at else "mamba",
                  "moe" if i % 2 == 1 else "dense")
        for i in range(period)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe_num_experts=16,
        moe_top_k=2,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        slots=_slots(8, attn_at=4),
        source="arXiv:2403.19887",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced",
        arch_type="hybrid",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        moe_num_experts=4,
        moe_top_k=2,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        slots=(LayerSlot("mamba", "dense"), LayerSlot("attn", "moe")),
        source="arXiv:2403.19887",
    )
