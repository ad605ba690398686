"""End-to-end training driver on the PyTorch port: a small qwen3-family
model for a few hundred steps, with fault-tolerant checkpointing, the
straggler watchdog, and PairwiseHist telemetry analytics over the run.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--d-model 256]
    PYTHONPATH=src python examples/torch_train_lm.py --steps 3 --layers 2 \\
        --device cpu

The port's counterpart of ``examples/train_lm.py``, with its flags plus
``--device``: the model trains on the CUDA device unless ``--device cpu``
(the full-size configs train under the production mesh via
``src/repro_torch/launch/train.py``).
"""
import argparse
import tempfile

from repro_torch.models.model import ModelConfig
from repro_torch.train.loop import train
from repro_torch.train.optimizer import Hyper
from repro_torch.train.telemetry import TelemetryStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true",
                    help="GD-inspired int8 gradient compression + EF")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="train-demo", vocab=2048, d_model=args.d_model,
        n_layers=args.layers, n_heads=4, n_kv=2,
        head_dim=args.d_model // 4, d_ff=args.d_model * 3,
        qk_norm=True, dtype="float32", attn_chunk=64)
    hyper = Hyper(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")

    compressor = None
    if args.grad_compress:
        from repro_torch.train.grad_compress import GDQuantizer
        compressor = GDQuantizer(bits=8)

    telemetry = TelemetryStore(device=args.device)
    state, hist = train(cfg, hyper, steps=args.steps, batch=args.batch,
                        seq=args.seq, ckpt_dir=ckpt_dir, ckpt_every=50,
                        compressor=compressor, telemetry=telemetry,
                        log_every=20, device=args.device)
    print(f"\nfinal step {int(state.step)}; loss "
          f"{hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"checkpoints in {ckpt_dir}")

    # AQP over the training telemetry (the paper's technique).
    telemetry.build()
    half = args.steps // 2
    for sql in (f"SELECT AVG(loss) FROM t WHERE step > {half}",
                "SELECT MAX(step_time) FROM t WHERE step > 10",
                "SELECT AVG(grad_norm) FROM t WHERE loss < 8"):
        res = telemetry.query(sql)
        if res.estimate is None:
            print(f"telemetry  {sql} ~ (no matching rows)")
        else:
            print(f"telemetry  {sql} ~ {res.estimate:.4f} "
                  f"[{res.lower:.4f}, {res.upper:.4f}]")


if __name__ == "__main__":
    main()
