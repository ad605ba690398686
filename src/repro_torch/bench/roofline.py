"""Roofline analysis from the dry run's artifacts.

The port of ``benchmarks/roofline.py``. Per (arch x shape) on the
single-pod mesh:

    compute term    = FLOPs / 989e12          dense bf16 peak
    memory term     = bytes / 3.35e12         HBM3
    collective term = wire bytes / 450e9      NVLink 4, per direction

The peaks are the spec sheet's for the card the port runs on, ``NVIDIA H100
80GB HBM3, 700.00 W`` (H100 SXM5), not measurements. The dry run
(``repro_torch.launch.dryrun``) reports *per-device* numbers, so each
divides by one card's rate. Its full-depth count is exact (the port's
layers are unrolled); a ``*_cost`` file (the U1/U2 pass) is used where it
exists and gives the same count. Memory comes from the full-depth cell.
MODEL_FLOPS uses 6*N*D (train) / 2*N*D (inference) with N_active for MoE.
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.launch.dryrun import RESULTS_DIR

H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # H100 SXM5 dense bf16, spec sheet
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4 per direction

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,
    "long_500k": 1,
}


def _params_of(arch: str):
    """(N_total, N_active) parameter counts from the config, analytically."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d = cfg.d_model
    emb = cfg.vocab * d
    total = emb + d  # embed + final norm
    active = total
    groups = cfg.layer_groups()
    for pat, n_rep in groups:
        for kind in pat:
            if kind.startswith("attn") or kind.startswith("moe"):
                attn = d * (cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim \
                    + cfg.n_heads * cfg.head_dim * d
                total += n_rep * (attn + 2 * d)
                active += n_rep * (attn + 2 * d)
                if kind.startswith("moe"):
                    router = d * cfg.n_experts
                    expert = 3 * d * cfg.d_ff_expert
                    shared = 3 * d * cfg.d_ff_expert * cfg.n_shared
                    total += n_rep * (router + cfg.n_experts * expert + shared)
                    active += n_rep * (router + cfg.top_k * expert + shared)
                else:
                    total += n_rep * 3 * d * cfg.d_ff
                    active += n_rep * 3 * d * cfg.d_ff
            elif kind == "ssm":
                din = cfg.ssm_expand * d
                nh = din // cfg.ssm_head_dim
                n_p = d * (2 * din + 2 * cfg.ssm_state + nh) + din * d + d
                total += n_rep * n_p
                active += n_rep * n_p
            elif kind == "rec":
                w = cfg.rnn_width
                n_p = 2 * d * w + 2 * w * w + w * d + 3 * d * cfg.d_ff + 2 * d
                total += n_rep * n_p
                active += n_rep * n_p
    return total, active


def load_cell(arch: str, shape: str, mesh: str) -> dict | None:
    names = (arch,
             arch.replace("-", "_").replace("0.6", "0_6").replace("1.3", "1_3"),
             arch.replace("_", "-"))
    for name in names:
        path = os.path.join(RESULTS_DIR, f"{name}__{shape}__{mesh}.json")
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
    return None


def analyze(arch: str, shape: str) -> dict | None:
    scan = load_cell(arch, shape, "single_pod")
    cost_rec = load_cell(arch, shape, "single_pod_cost")
    if scan is None or scan.get("skipped"):
        return {"arch": arch, "shape": shape,
                "skipped": scan.get("reason") if scan else "missing"}
    cost_src = cost_rec if cost_rec and cost_rec.get("ok") else scan
    cost = cost_src.get("cost_analysis", {})
    flops_dev = cost.get("flops", 0.0)
    bytes_dev = cost.get("bytes accessed", 0.0)
    coll = cost_src.get("collectives", {})
    wire_dev = sum(v.get("wire_bytes_per_device", 0.0) for v in coll.values())

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = wire_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = t_compute / bound if bound > 0 else 0.0

    n_total, n_active = _params_of(arch)
    toks = SHAPE_TOKENS[shape]
    mult = 6 if shape == "train_4k" else 2
    model_flops = mult * n_active * toks
    n_dev = scan.get("n_devices", 256)
    hlo_total = flops_dev * n_dev
    useful = model_flops / hlo_total if hlo_total else 0.0

    mem = scan.get("memory_analysis", {})
    return {
        "arch": arch, "shape": shape, "n_devices": n_dev,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire_dev,
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": frac,     # compute / dominant (1.0 = compute-bound)
        "model_flops": model_flops,
        "useful_flops_ratio": useful,
        "n_params_total": n_total, "n_params_active": n_active,
        "temp_bytes_per_device": mem.get("temp_size_in_bytes"),
        "arg_bytes_per_device": mem.get("argument_size_in_bytes"),
        "collectives": coll,
        "cost_source": ("u1u2-extrapolated" if cost_src is cost_rec
                        else "full depth"),
    }


_SUGGEST = {
    "compute": "compute-bound: raise tensor-core utilization (fuse "
               "elementwise into matmuls, bf16 everywhere, drop redundant "
               "remat recompute)",
    "memory": "HBM-bound: cut activation traffic (fusion, smaller remat "
              "residuals, bf16 logits / chunked cross-entropy)",
    "collective": "NVLink-bound: reshard to remove all-gathers (bf16-cast "
                  "before the FSDP gather, sequence-shard boundary, larger "
                  "per-device batch)",
}


def _arch_name(arch_us: str) -> str:
    return arch_us.replace("_", "-").replace("-0-6b", "-0.6b") \
        .replace("-1-3b", "-1.3b")


def markdown_table(shapes=None, archs=None) -> str:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import specs as S
    shapes = shapes or list(S.SHAPES)
    archs = archs or list(ARCHS)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "roofline frac | useful-FLOP ratio | next move |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in archs:
        for shape in shapes:
            r = analyze(_arch_name(arch), shape)
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {r['arch']} | {shape} | — | — | — | skipped |"
                             f" — | — | {r['skipped'][:48]} |")
                continue
            lines.append(
                f"| {r['arch']} | {shape} | {r['compute_s']:.4f} | "
                f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
                f"{r['dominant']} | {r['roofline_fraction']:.2f} | "
                f"{r['useful_flops_ratio']:.2f} | "
                f"{_SUGGEST[r['dominant']][:64]} |")
    return "\n".join(lines)


def run(rows: list, quick: bool = False, device=None, out_dir=None) -> dict:
    """One row per dry-run cell found under ``RESULTS_DIR`` (cells not run
    yet report ``missing``). It reads files and runs on no device; ``quick``
    and ``device`` are the suites' common arguments and change nothing."""
    from repro_torch.bench.common import emit, save_json
    from repro_torch.configs import ARCHS
    from repro_torch.launch import specs as S
    out = {"peaks_of": H100, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
           "link_bw": LINK_BW}
    for arch_us in ARCHS:
        arch = _arch_name(arch_us)
        for shape in S.SHAPES:
            r = analyze(arch, shape)
            out[f"{arch}/{shape}"] = r
            if "skipped" in r:
                emit(rows, f"roofline/{arch}/{shape}", None,
                     f"skipped:{r['skipped'][:40]}")
            else:
                emit(rows, f"roofline/{arch}/{shape}", None,
                     f"dom={r['dominant']}/frac={r['roofline_fraction']:.2f}"
                     f"/useful={r['useful_flops_ratio']:.2f}")
    save_json("roofline", out, torch.device("cpu"), out_dir)
    return out


if __name__ == "__main__":
    print(markdown_table())
