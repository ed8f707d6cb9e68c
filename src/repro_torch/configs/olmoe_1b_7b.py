"""OLMoE-1B-7B — MoE with 64 experts top-8 [arXiv:2409.02060]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        rope_theta=10000.0,
        decode_window=16384,
        moe_num_experts=64,
        moe_top_k=8,
        slots=(LayerSlot("attn", "moe"),),
        source="arXiv:2409.02060",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-reduced",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=128,
        vocab_size=1024,
        rope_theta=10000.0,
        decode_window=64,
        moe_num_experts=4,
        moe_top_k=2,
        slots=(LayerSlot("attn", "moe"),),
        source="arXiv:2409.02060",
    )
