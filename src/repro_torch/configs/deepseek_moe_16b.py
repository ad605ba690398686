"""DeepSeekMoE-16B [arXiv:2401.06066; hf].

28L, d_model 2048, 16 heads (kv=16 i.e. MHA, head_dim 128), vocab 102400.
Fine-grained MoE: 64 routed experts top-6 + 2 shared experts, expert d_ff
1408; layer 0 is a dense FFN (d_ff 10944).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", vocab=102400, d_model=2048, n_layers=28,
        n_heads=16, n_kv=16, head_dim=128, d_ff=10944,
        block_pattern=("moe",), first_dense=True,
        n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", vocab=512, d_model=96, n_layers=3,
        n_heads=4, n_kv=4, head_dim=24, d_ff=256,
        block_pattern=("moe",), first_dense=True,
        n_experts=8, top_k=2, n_shared=1, d_ff_expert=64,
        attn_chunk=64,
    )
