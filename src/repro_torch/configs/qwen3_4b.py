"""Qwen3-4B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        arch_type="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        decode_window=16384,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:Qwen/Qwen3-8B",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        qk_norm=True,
        rope_theta=1000000.0,
        decode_window=64,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:Qwen/Qwen3-8B",
    )
