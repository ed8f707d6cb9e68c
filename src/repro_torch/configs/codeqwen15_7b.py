"""CodeQwen1.5-7B — dense, MHA-style GQA (kv=heads) [hf:Qwen/CodeQwen1.5-7B]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        arch_type="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        rope_theta=1000000.0,
        decode_window=16384,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:Qwen/CodeQwen1.5-7B",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-reduced",
        arch_type="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        rope_theta=1000000.0,
        decode_window=64,
        slots=(LayerSlot("attn", "dense"),),
        source="hf:Qwen/CodeQwen1.5-7B",
    )
