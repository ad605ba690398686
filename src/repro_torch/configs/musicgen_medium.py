"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L, d_model 1536, 24 heads (MHA kv=24, head_dim 64), d_ff 6144, vocab 2048
(one EnCodec codebook head; the 4-codebook delay-pattern frontend is a STUB:
``input_specs`` supplies pre-computed frame embeddings per the assignment).
24 heads do not divide 16 -> attention shards on batch only.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", vocab=2048, d_model=1536, n_layers=48,
        n_heads=24, n_kv=24, head_dim=64, d_ff=6144,
        embed_inputs=True, heads_shardable=False, attn_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", vocab=256, d_model=96, n_layers=2,
        n_heads=6, n_kv=6, head_dim=16, d_ff=288,
        embed_inputs=True, heads_shardable=False, attn_chunk=32,
    )
