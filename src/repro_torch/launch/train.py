"""LM training command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 100                              # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 3 --smoke --device cpu           # CPU-sized smoke run

The reference's flags and defaults, plus ``--device``: without it the run
is on the CUDA device and fails without one. ``--smoke`` takes the
architecture's reduced config in f32; otherwise the published config
computes in its dtype from f32 master weights. Sharded meshes (``--mesh
single|multi``) are not ported yet (ROADMAP Queue 1 item 6c).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.train.loop import train
from repro_torch.train.optimizer import Hyper


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--mesh", choices=("none", "single", "multi"),
                    default="none",
                    help="a sharded mesh (not ported: ROADMAP item 6c)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, telemetry=None):
    """Train as ``args`` say; returns (final TrainState, history)."""
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            "(ROADMAP Queue 1 item 6c)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    compressor = None
    if args.grad_compress:
        from repro_torch.train.grad_compress import GDQuantizer
        compressor = GDQuantizer(bits=8)
    hyper = Hyper(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    return train(cfg, hyper, steps=args.steps, batch=args.batch,
                 seq=args.seq, ckpt_dir=args.ckpt_dir,
                 microbatches=args.microbatches, compressor=compressor,
                 telemetry=telemetry, device=device)


def main(argv=None):
    state, hist = run(parse(argv))
    print(f"done: step {int(state.step)}, "
          f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}, "
          f"flagged steps: {hist['flagged_steps']}")
    return state, hist


if __name__ == "__main__":
    main()
