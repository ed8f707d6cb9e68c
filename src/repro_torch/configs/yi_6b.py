"""Yi-6B — llama-arch dense GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        arch_type="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5000000.0,
        decode_window=16384,
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2403.04652",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        rope_theta=5000000.0,
        decode_window=64,
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2403.04652",
    )
