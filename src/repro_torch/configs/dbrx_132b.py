"""DBRX-132B [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), vocab 100352,
fine-grained MoE: 16 experts, top-4, expert d_ff 10752.
16 experts shard exactly onto the 16-way tensor axis (1 expert/device).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", vocab=100352, d_model=6144, n_layers=40,
        n_heads=48, n_kv=8, head_dim=128,
        block_pattern=("moe",), n_experts=16, top_k=4, d_ff_expert=10752,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", vocab=512, d_model=96, n_layers=2,
        n_heads=4, n_kv=2, head_dim=24,
        block_pattern=("moe",), n_experts=4, top_k=2, d_ff_expert=128,
        attn_chunk=64,
    )
