"""The LM stack's models (port of ``src/repro/models``): configs' dataclass,
the layer library and the model's init, forward, prefill and decode."""
from repro_torch.models.model import (  # noqa: F401
    ModelConfig,
    init_params,
    forward,
    loss_fn,
    init_cache,
    prefill,
    decode_step,
)
