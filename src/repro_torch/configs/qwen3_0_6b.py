"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family].

28L, d_model 1024, 16 heads (GQA kv=8, explicit head_dim 128), d_ff 3072,
vocab 151936, per-head q/k RMSNorm (qk_norm).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", vocab=151936, d_model=1024, n_layers=28,
        n_heads=16, n_kv=8, head_dim=128, d_ff=3072,
        qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", vocab=512, d_model=96, n_layers=2,
        n_heads=4, n_kv=2, head_dim=24, d_ff=288, qk_norm=True,
        attn_chunk=64,
    )
