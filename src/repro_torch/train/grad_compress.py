"""GD-inspired gradient compression with error feedback.

The port of ``src/repro/train/grad_compress.py``. Each step the gradient
is split into a quantized base grid (what the optimizer consumes) and a
deviation that enters an error-feedback accumulator and reappears on later
steps (cf. EF-SGD; held by ``tests/test_torch_train.py::
test_grad_compression_error_feedback_converges``). Two codecs:

  * ``GDQuantizer`` — one scale a leaf + an int8 base grid (the "base
    bits"), error feedback carries the deviation;
  * ``TopKCompressor`` — classical sparsification baseline.

Both work per leaf of the reference's parameter tree, where a layer
group's leaf stacks that parameter of every repeat: ``GDQuantizer``'s
scale is ``max|g|`` over all the group's ``wq`` at once, and
``TopKCompressor``'s ``k`` and threshold are taken over them together
(``convert.reference_leaves``). ``init(model)`` binds a codec to the
model's leaves. As in the reference, this is the algorithmic half
(quantization and error feedback); no collective moves the int8 grid.
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import reference_leaves


class _Codec:
    def init(self, model) -> dict:
        """Zero f32 error feedback beside ``model``'s parameters; binds
        the codec to the model's reference leaves."""
        self._leaves = reference_leaves(model.cfg)
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in model.named_parameters()}

    def compress(self, grads: dict, err: dict):
        """Returns (decompressed grads as seen by the optimizer, new error),
        both ``{name: tensor}``."""
        out, new_err = {}, {}
        for leaf in self._leaves:
            g32 = [grads[n].float() + err[n] for n in leaf.names]
            kept = self._one(g32)
            for name, g, k in zip(leaf.names, g32, kept):
                out[name], new_err[name] = k, g - k
        return out, new_err


class GDQuantizer(_Codec):
    """int8 base / error-feedback deviation gradient codec."""

    def __init__(self, bits: int = 8):
        if bits not in (4, 8):
            raise ValueError("bits must be 4 or 8")
        self.bits = bits
        self.levels = 2 ** (bits - 1) - 1

    def _one(self, g32: list) -> list:
        amax = torch.stack([torch.max(torch.abs(g)) for g in g32]).max()
        scale = torch.clamp(amax, min=1e-12) / self.levels
        out = []
        for g in g32:
            base = torch.clamp(torch.round(g / scale), -self.levels,
                               self.levels).to(torch.int8)
            out.append(base.float() * scale)   # "base" part, transmitted
        return out


class TopKCompressor(_Codec):
    """Keep the top-k fraction of entries per leaf; error-feedback rest."""

    def __init__(self, frac: float = 0.1):
        self.frac = frac

    def _one(self, g32: list) -> list:
        flat = torch.cat([torch.abs(g).reshape(-1) for g in g32])
        k = max(1, int(flat.numel() * self.frac))
        thresh = torch.topk(flat, k).values[-1]
        return [torch.where(torch.abs(g) >= thresh, g, 0.0) for g in g32]


def make_compressing_hook(codec, err_state_holder: dict):
    """Adapter for ``make_train_step(compressor=...)``: the error-feedback
    state lives outside ``TrainState`` in ``err_state_holder["err"]``, so
    the hook takes and returns the state explicitly."""
    def hook(grads, state):
        err = err_state_holder["err"]
        new_grads, new_err = codec.compress(grads, err)
        err_state_holder["err"] = new_err
        return new_grads, state
    return hook
