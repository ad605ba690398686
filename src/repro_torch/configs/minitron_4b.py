"""Minitron-4B — width/depth-pruned Nemotron [arXiv:2407.14679; hf].

32L, d_model 3072, 24 heads (GQA kv=8, head_dim 128), d_ff 9216, vocab 256000.
24 heads do not divide the 16-way tensor axis -> attention activations shard
on batch only (heads_shardable=False); MLP/vocab dims still shard 16-way.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", vocab=256000, d_model=3072, n_layers=32,
        n_heads=24, n_kv=8, head_dim=128, d_ff=9216,
        rope_theta=10000.0, heads_shardable=False, attn_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", vocab=512, d_model=96, n_layers=2,
        n_heads=6, n_kv=2, head_dim=16, d_ff=288,
        heads_shardable=False, attn_chunk=64,
    )
