"""LLaVA-NeXT-34B — VLM: anyres-tiled vision frontend (stub) + dense GQA
decoder backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The SigLIP/ViT tower and projector input are stubbed: ``input_specs()``
supplies precomputed patch embeddings (frontend_dim=1152); the backbone
projects and consumes them as the sequence prefix."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        arch_type="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5000000.0,
        decode_window=16384,
        frontend="vision",
        frontend_dim=1152,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-reduced",
        arch_type="vlm",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        rope_theta=5000000.0,
        decode_window=64,
        frontend="vision",
        frontend_dim=96,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
