"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38L, d_model 4096, pattern 2 recurrent (RG-LRU, width 4096) : 1 local
attention (window 2048, MQA kv=1, head_dim 256), d_ff 12288, vocab 256000,
GeGLU. Fixed-size state + ring local cache -> runs long_500k decode.
38 = 12 x (rec, rec, attn_local) + (rec, rec).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", vocab=256000, d_model=4096, n_layers=38,
        n_heads=16, n_kv=1, head_dim=256, d_ff=12288,
        block_pattern=("rec", "rec", "attn_local"),
        window=2048, rnn_width=4096, rnn_conv=4,
        mlp_act="gelu", sub_quadratic=True, attn_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", vocab=512, d_model=96, n_layers=5,
        n_heads=4, n_kv=1, head_dim=24, d_ff=288,
        block_pattern=("rec", "rec", "attn_local"),
        window=32, rnn_width=96, rnn_conv=4,
        mlp_act="gelu", sub_quadratic=True, attn_chunk=32,
    )
