"""Qwen3-30B-A3B — fine-grained MoE, 128 experts top-8, qk-norm
[hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        decode_window=16384,
        moe_num_experts=128,
        moe_top_k=8,
        slots=(LayerSlot("attn", "moe"),),
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-reduced",
        arch_type="moe",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab_size=1024,
        qk_norm=True,
        rope_theta=1000000.0,
        decode_window=64,
        moe_num_experts=4,
        moe_top_k=2,
        slots=(LayerSlot("attn", "moe"),),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
