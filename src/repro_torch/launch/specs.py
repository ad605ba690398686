"""Input specifications for every (architecture x shape) dry-run cell.

The port of ``src/repro/launch/specs.py``. Each spec is a ``meta`` tensor
(shape and dtype, never allocated) beside its logical axes; the dry run
turns each into a DTensor of those placements.

Assigned shapes (LM family):
  train_4k     seq 4096,   global_batch 256   (training)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   cache 32768, global_batch 128  (inference decode, 1 token)
  long_500k    cache 524288, global_batch 1   (long-context decode;
               sub-quadratic archs only)
"""
from __future__ import annotations

import torch

from repro_torch.models.model import ModelConfig, cache_axes, init_cache

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "requires sub-quadratic attention (DESIGN.md note)")
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Training batch: ``{name: (meta tensor, logical axes)}``."""
    specs = {"labels": (_meta((batch, seq), torch.int32), ("batch", None))}
    if cfg.embed_inputs:
        specs["embeds"] = (_meta((batch, seq, cfg.d_model), torch.bfloat16),
                           ("batch", None, "embed"))
    else:
        specs["tokens"] = (_meta((batch, seq), torch.int32), ("batch", None))
    return specs


def token_specs(cfg: ModelConfig, batch: int) -> tuple:
    if cfg.embed_inputs:
        return (_meta((batch, 1, cfg.d_model), torch.bfloat16),
                ("batch", None, "embed"))
    return _meta((batch,), torch.int32), ("batch",)


def prompt_specs(cfg: ModelConfig, batch: int, seq: int) -> tuple:
    if cfg.embed_inputs:
        return (_meta((batch, seq, cfg.d_model), torch.bfloat16),
                ("batch", None, "embed"))
    return _meta((batch, seq), torch.int32), ("batch", None)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """(``Cache`` of meta tensors, each layer's cache axes in layer
    order)."""
    return init_cache(cfg, batch, max_len, device="meta"), cache_axes(cfg)
