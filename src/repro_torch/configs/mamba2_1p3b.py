"""Mamba2-1.3B — attention-free SSM with SSD [arXiv:2405.21060]."""

from repro_torch.configs.base import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        arch_type="ssm",
        num_layers=48,
        d_model=2048,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        slots=(LayerSlot("mamba", "none"),),
        source="arXiv:2405.21060",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-reduced",
        arch_type="ssm",
        num_layers=2,
        d_model=256,
        d_ff=0,
        vocab_size=1024,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        slots=(LayerSlot("mamba", "none"),),
        source="arXiv:2405.21060",
    )
