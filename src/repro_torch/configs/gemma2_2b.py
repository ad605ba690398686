"""Gemma-2 2B [arXiv:2408.00118; hf].

26L, d_model 2304, 8 heads (GQA kv=4, explicit head_dim 256), d_ff 9216,
vocab 256000. Alternating local (window 4096) / global attention, attention
softcap 50, final-logit softcap 30, GeGLU MLP. 8 heads < 16-way tensor axis
-> attention shards on batch only.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", vocab=256000, d_model=2304, n_layers=26,
        n_heads=8, n_kv=4, head_dim=256, d_ff=9216,
        block_pattern=("attn_local", "attn_global"),
        window=4096, attn_softcap=50.0, logit_softcap=30.0,
        mlp_act="gelu", heads_shardable=False, attn_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", vocab=512, d_model=96, n_layers=4,
        n_heads=4, n_kv=2, head_dim=24, d_ff=288,
        block_pattern=("attn_local", "attn_global"),
        window=32, attn_softcap=50.0, logit_softcap=30.0,
        mlp_act="gelu", heads_shardable=False, attn_chunk=32,
    )
