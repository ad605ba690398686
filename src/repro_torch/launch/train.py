"""LM training command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 100                              # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 3 --smoke --device cpu           # CPU-sized smoke run

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --mesh single                            # (data=16, model=16), NCCL

The reference's flags and defaults, plus ``--device``: without it the run
is on the CUDA device and fails without one. ``--smoke`` takes the
architecture's reduced config in f32; otherwise the published config
computes in its dtype from f32 master weights. ``--mesh single|multi``
installs the production mesh (``launch.mesh``; 256 or 512 ranks, each
under ``torchrun``, NCCL) with the dry run's rules for the architecture
and trains sharded; with any other world size it raises, naming the one
it needs. ``--microbatches`` and ``--grad-compress`` work with ``--mesh``
as without it: each microbatch is sharded over the data ranks, and the
codec's error feedback over the parameters' placements.
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
                    help="the production mesh: single (256 ranks) or multi "
                         "(512), under torchrun")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    return ap.parse_args(argv)


def install_mesh(kind: str, cfg):
    """Join the ``torchrun`` job (NCCL), pin this rank's card and install
    the production mesh of ``kind`` with ``dryrun.arch_rules``; raises
    unless the job has the mesh's 256 or 512 ranks. Returns the rank's
    device."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import set_mesh
    need = 512 if kind == "multi" else 256
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise RuntimeError(f"--mesh {kind} needs {need} ranks under "
                           f"torchrun (WORLD_SIZE={need}); this run has "
                           f"{world}")
    dist.init_process_group("nccl")
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    set_mesh(mesh, arch_rules(cfg, mesh.size(mesh.mesh_dim_names.index(
        "model"))))
    return device


def run(args: argparse.Namespace, telemetry=None):
    """Train as ``args`` say; returns (final TrainState, history)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    device = install_mesh(args.mesh, cfg) if args.mesh != "none" \
        else resolve_device(args.device)
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
