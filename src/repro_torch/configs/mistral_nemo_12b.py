"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model 5120, 32 heads (GQA kv=8), explicit head_dim 128 (not 5120/32),
d_ff 14336, vocab 131072, 128k-context rope theta 1e6.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", vocab=131072, d_model=5120, n_layers=40,
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", vocab=512, d_model=128, n_layers=2,
        n_heads=4, n_kv=2, head_dim=32, d_ff=384, rope_theta=1_000_000.0,
        attn_chunk=64,
    )
