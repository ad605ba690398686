"""InternVL2-76B [arXiv:2404.16821] — Llama-3-70B-class language backbone.

80L, d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 28672,
vocab 128256. The InternViT vision frontend is a STUB per the assignment:
``input_specs`` supplies pre-computed patch embeddings (B, S, d_model).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", vocab=128256, d_model=8192, n_layers=80,
        n_heads=64, n_kv=8, head_dim=128, d_ff=28672,
        rope_theta=500_000.0, embed_inputs=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke", vocab=512, d_model=128, n_layers=2,
        n_heads=4, n_kv=2, head_dim=32, d_ff=384, embed_inputs=True,
        attn_chunk=64,
    )
