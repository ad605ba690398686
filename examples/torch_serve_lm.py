"""Batched LM serving on the PyTorch port: prefill + decode with continuous
slot refill.

    PYTHONPATH=src python examples/torch_serve_lm.py                 # card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port's counterpart of ``examples/serve_lm.py``: qwen3's smoke config
in f32 with weights drawn from seed 0, on the CUDA device unless
``--device cpu``.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype="float32")
    model = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    engine = ServeEngine(model, batch_slots=4, max_len=256, device=dev)

    rng = np.random.default_rng(7)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new_tokens=16)
        for n in (24, 18, 24, 30, 12, 24, 20)
    ]
    t0 = time.perf_counter()
    engine.generate(requests)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in requests)
    print(f"{len(requests)} requests over {engine.slots} slots: "
          f"{total_new} tokens in {wall:.2f}s "
          f"({total_new/wall:.1f} tok/s on {dev})")
    print(f"stats: {engine.last_stats}")
    for i, req in enumerate(requests):
        print(f"req{i}: prompt[{len(req.prompt)}] -> {req.out_tokens}")


if __name__ == "__main__":
    main()
