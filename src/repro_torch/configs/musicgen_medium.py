"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  The EnCodec codec is the (stubbed) frontend: the
decoder consumes discrete audio tokens (vocab 2048); the codebook delay
pattern is a data-layout detail outside the backbone."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        rope_theta=10000.0,
        decode_window=16384,
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2306.05284",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-reduced",
        arch_type="audio",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        rope_theta=10000.0,
        decode_window=64,
        slots=(LayerSlot("attn", "dense"),),
        source="arXiv:2306.05284",
    )
