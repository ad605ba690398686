"""Mamba2-1.3B [arXiv:2405.21060] — SSD (state-space duality), attention-free.

48L, d_model 2048 (d_inner 4096 = 2x expand, 64 heads of head_dim 64,
d_state 128, conv width 4), vocab 50280. Constant-size recurrent state ->
runs the long_500k decode shape.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", vocab=50280, d_model=2048, n_layers=48,
        block_pattern=("ssm",), ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, ssm_conv=4, ssm_chunk=256, sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", vocab=512, d_model=64, n_layers=2,
        block_pattern=("ssm",), ssm_state=16, ssm_head_dim=16,
        ssm_expand=2, ssm_conv=4, ssm_chunk=32, sub_quadratic=True,
    )
