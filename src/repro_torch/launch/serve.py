"""LM serving command line (batched prefill + decode).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu

Without ``--device`` it runs on the CUDA device and fails without one.
Weights come from the port's own init (seed 0); ``--smoke`` takes the
architecture's reduced config in f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    """Serve ``--requests`` random 16-token prompts; returns the engine's
    stats with the token count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = ServeEngine(model, batch_slots=args.slots,
                         max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, 16).astype(np.int32),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    engine.generate(reqs)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"{tokens} tokens / {wall:.2f}s = {tokens/wall:.1f} tok/s on "
          f"{device}; stats {engine.last_stats}")
    return dict(engine.last_stats, tokens=tokens)


if __name__ == "__main__":
    main()
