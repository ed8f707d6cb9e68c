"""Llama-3-8B — dense, GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        arch_type="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
        decode_window=16384,   # sliding-window variant for long_500k decode
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2407.21783",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        rope_theta=500000.0,
        decode_window=64,
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2407.21783",
    )
