"""The sharded step's recurrent layers, router, tied logits, MoE, attention
and MLP at a narrow width on the port: per-device matmul FLOPs and peak
bytes of each product group under a (data 2, model 4) mesh of fake ranks.

    PYTHONPATH=src python scripts/torch_narrow_sharding.py [--out FILE]

For every case (``PEAK_LAYERS`` x ``RULES`` x ``WRT``) it prints one JSON
line: the port's matmul FLOPs on a fake 8-rank mesh under the dry run's
``DeviceCost`` (all, and those of 2-D products), and the peak of the
bytes it allocates and its inputs' local shards (each storage counted
once, as the dry run counts them); then, under each rule set, the FLOPs
of the products of the tied table in mamba2-1.3b's one-layer
``train_4k`` dry run on (16, 16) (``head_full_port``) and the peak of
that head alone at full width (``FULL_HEAD``); then the FLOPs and the
peak of the attention of ``FULL_ATTENTION`` at full width under the base
rules, for the parameters.
``tests/test_torch_sharded_recurrent.py`` holds these against the
reference's compiled HLO; run as a script it prints both side by side.

Layers: mamba2's SSD (d_model 128, expand 2, head_dim 16, state 16, chunk
16: 16 heads, an in_proj of 560 = 4 x 140 columns, cut at z, xBC and dt
off the 140-column edges, as the full width's 8,512 are off its 532);
recurrentgemma's RG-LRU (d_model and rnn_width 128); dbrx's router (8
experts); the tied head (final norm, logits, the loss's logsumexp and
gold logit) with a vocab of 512, which ``model`` divides, and of 514,
which it does not; dbrx's MoE under both dispatches (the width of
``tests/test_torch_sharded_moe.py``: 8 experts, top 2, d_ff_expert 64,
capacity 20); qwen3's attention and MLP (the narrow widths of
``tests/test_torch_sharded_projections.py``); gemma2-2b's attention with
its heads whole on ``model``, its softcap and its sequence in 8 chunks.
Each under the base rules and the ``zero_r`` and ``seq_sp`` variants; the
gradient of the parameters, and of the parameters and the input. With
``--live`` it adds to each line the largest groups of storages live at
the peak. It needs only torch.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
from pathlib import Path

MESH = (2, 4)
BATCH, SEQ = 4, 64
LAYERS = ("ssm", "rec", "router", "head512", "head514")
RESID = ("batch", "resid_seq", "resid_embed")
RULES = ("base", "zero_r", "seq_sp")
WRT = ("params", "params_x")

# Narrow configs: (architecture, overrides); a head's vocab is its name's.
NARROW = {
    "ssm": ("mamba2-1.3b", dict(d_model=128, ssm_expand=2, ssm_head_dim=16,
                                ssm_state=16, ssm_chunk=16)),
    "rec": ("recurrentgemma-9b", dict(d_model=128, rnn_width=128)),
    "router": ("dbrx-132b", dict(d_model=128, n_experts=8, top_k=2,
                                 d_ff_expert=64)),
    "head": ("mamba2-1.3b", dict(d_model=128)),
    # The widths of tests/test_torch_sharded_{projections,moe}.py.
    "attention": ("qwen3-0.6b", dict(d_model=128, n_heads=8, n_kv=2,
                                     head_dim=32, d_ff=384)),
    "mlp": ("qwen3-0.6b", dict(d_model=128, n_heads=8, n_kv=2, head_dim=32,
                               d_ff=384)),
    "moe_einsum": ("dbrx-132b", dict(d_model=128, n_experts=8, top_k=2,
                                     d_ff_expert=64, moe_impl="einsum")),
    "moe_sort": ("dbrx-132b", dict(d_model=128, n_experts=8, top_k=2,
                                   d_ff_expert=64, moe_impl="sort")),
    # gemma2-2b's attention: its heads kept whole on ``model`` (6 query
    # and 3 kv heads, which ``model`` does not divide either), the softcap,
    # the sequence in 8 chunks as train_4k's 4,096 are in chunks of 512.
    "attention_gemma2": ("gemma2-2b", dict(d_model=128, n_heads=6, n_kv=3,
                                           head_dim=32, d_ff=384,
                                           attn_chunk=8)),
    # The attention at full width (``FULL_ATTENTION``): the heads of all
    # three whole on ``model``, the sequence in 8 chunks of 512.
    "attention_gemma2-2b": ("gemma2-2b", {}),
    "attention_minitron-4b": ("minitron-4b", {}),
    "attention_musicgen-medium": ("musicgen-medium", {}),
}
# Layers whose peaks are held to the reference's beside those of
# ``cases()``, which also have their dots held (``peak_cases``).
PEAK_LAYERS = LAYERS + ("moe_einsum", "moe_sort", "attention", "mlp",
                        "attention_gemma2")

# train_4k's batch on (data 16, model 16), for the cases at full width.
FULL_SHAPE = dict(mesh_shape=(16, 16), batch=256, seq=4096)
# The tied head at mamba2-1.3b's full width (d_model 2,048, vocab 50,280,
# which ``model`` does not divide): ``port(FULL_HEAD, rules, "params_x",
# **FULL_SHAPE)``.
FULL_HEAD = "head_full"
# The attention of three archs at full width, f32: ``port(layer, "base",
# "params", **FULL_SHAPE)``.
FULL_ATTENTION = ("attention_gemma2-2b", "attention_minitron-4b",
                  "attention_musicgen-medium")


def cases(layers=LAYERS):
    return [(layer, rules, wrt) for layer in layers for rules in RULES
            for wrt in WRT]


def peak_cases():
    return cases(PEAK_LAYERS)


def narrow_cfg(layer: str):
    from repro_torch.configs import get_config
    if layer == FULL_HEAD:
        return dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32")
    arch, over = NARROW[layer if layer in NARROW
                        else layer.rstrip("0123456789")]
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    if layer.startswith("head"):
        cfg = dataclasses.replace(cfg, vocab=int(layer[4:]))
    return cfg


def _module(layer: str, cfg, batch: int, seq: int):
    """(module on the meta device, its parameters' logical axes, the
    loss of the module and the input, the input's logical axes)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.sharding import constrain
    if layer == "ssm":
        return (L.SSM(cfg, device="meta", dtype=torch.float32), L.ssm_axes(),
                lambda p, x: (constrain(L.ssm_apply(p, x, cfg)[0], *RESID)
                              ** 2).sum(), ("batch", None, "blk_in_embed"))
    if layer == "rec":
        return (L.RGLRU(cfg, device="meta", dtype=torch.float32),
                L.rglru_axes(),
                lambda p, x: (constrain(L.rglru_apply(p, x, cfg)[0],
                                        *RESID) ** 2).sum(),
                ("batch", None, "blk_in_embed"))
    other = {
        "attention": (L.Attention, L.attention_axes(cfg),
                      lambda p, x: L.attention_apply(p, x, cfg,
                                                     local=False)),
        "mlp": (L.MLP, L.mlp_axes(), lambda p, x: L.mlp_apply(p, x, cfg)),
        "moe": (L.MoE, L.moe_axes(cfg), lambda p, x: L.moe_apply(p, x, cfg)),
    }.get(layer.partition("_")[0])
    if other is not None:
        make, axes, apply = other
        return (make(cfg, device="meta", dtype=torch.float32), axes,
                lambda p, x: (constrain(apply(p, x), *RESID) ** 2).sum(),
                ("batch", None, "blk_in_embed"))
    module = torch.nn.Module()
    if layer == "router":
        module.router = torch.nn.Parameter(torch.empty(
            cfg.d_model, cfg.n_experts, device="meta"))
        return (module, {"router": L.moe_axes(cfg)["router"]},
                lambda p, x: (L._moe_router(p, x, cfg)[0] ** 2).sum(),
                ("batch", None, "blk_in_embed"))
    module.embed = torch.nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                                  device="meta"))
    module.ln_f = torch.nn.Parameter(torch.empty(cfg.d_model, device="meta"))

    def loss(p, x):
        from repro_torch.launch import dryrun as D
        labels = D._dtensor(torch.empty(batch, seq, dtype=torch.long,
                                        device="meta"), ("batch", None),
                            x.device_mesh)
        logits = M.head_apply(x, p.ln_f, p.embed, cfg)
        return M._nll(logits, labels).sum() / (batch * seq)
    return (module, {"embed": ("vocab", "fsdp"), "ln_f": (None,)}, loss,
            RESID)


def port(layer: str, rules_name: str, wrt: str, mesh_shape=MESH,
         batch: int = BATCH, seq: int = SEQ) -> dict:
    """Rank 0's matmul FLOPs (all, and those of 2-D products) and peak
    bytes of one case on a fake (data, model) mesh of ``mesh_shape`` (the
    narrow (2, 4) by default) with an input of ``batch`` x ``seq`` tokens,
    the parameters and the input DTensors of fake shards."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import replicate_plain, set_mesh
    cfg = narrow_cfg(layer)
    module, axes, loss, x_axes = _module(layer, cfg, batch, seq)
    two_d = collections.Counter()
    dispatch = D.DeviceCost.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if func._overloadpacket is torch.ops.aten.mm:
            two_d["mm"] += self.flops - before
        return out

    D.DeviceCost.__torch_dispatch__ = counting
    try:
        with D.fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = make_mesh(mesh_shape, ("data", "model"))
            rules = D.arch_rules(cfg, mesh_shape[1])
            if rules_name != "base":
                rules.update(D.VARIANTS[rules_name]["rules"])
            set_mesh(mesh, rules)
            try:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    for n, p in list(module.named_parameters()):
                        module._parameters[n] = torch.nn.Parameter(
                            D._dtensor(p, axes[n], mesh))
                    x = D._dtensor(torch.empty(batch, seq, cfg.d_model,
                                               device="meta"), x_axes, mesh)
                    x.requires_grad_(wrt == "params_x")
                cost = D.DeviceCost()
                inputs = list(module.parameters()) + [x]
                wrt_ = inputs if wrt == "params_x" else inputs[:-1]
                cost.register(inputs, "arguments")
                with cost, replicate_plain():
                    torch.autograd.grad(loss(module, x), wrt_)
            finally:
                set_mesh(None)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    return {"flops": cost.flops, "mm": two_d["mm"], "peak_bytes": cost.peak}


def head_full_port(rules_name: str) -> int:
    """The port's per-device FLOPs of the products that involve the tied
    table in mamba2-1.3b's train_4k dry run on (16, 16) cut to one layer
    (``rules_name`` a variant of ``dryrun.VARIANTS`` or ``"base"``): the
    logits and their gradients, read off the dry run's tally."""
    import importlib.util
    from repro_torch.configs import get_config
    spec = importlib.util.spec_from_file_location(
        "torch_dryrun_flops",
        Path(__file__).with_name("torch_dryrun_flops.py"))
    flops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flops)
    res, counts = flops.tally("mamba2-1.3b", "train_4k", False, 1,
                              None if rules_name == "base" else rules_name)
    if not res.get("ok"):
        raise RuntimeError(res.get("error"))
    vocab = str(get_config("mamba2-1.3b").vocab)
    return int(sum(n for key, n in counts.items()
                   if vocab in key.replace("(", " ").replace(")", " ")
                   .replace(",", " ").split()))


def port_live(layer: str, rules_name: str, wrt: str, top: int = 12,
              **shape) -> dict:
    """``port``'s record and the ``top`` largest groups of storages live
    at its peak (``torch_dryrun_flops.recording_live``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_dryrun_flops",
        Path(__file__).with_name("torch_dryrun_flops.py"))
    flops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flops)
    with flops.recording_live(top) as snap:
        res = port(layer, rules_name, wrt, **shape)
    return {**res, "live": snap["live"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--live", action="store_true",
                    help="add the storages live at each case's peak")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    run = port_live if args.live else port
    lines = [json.dumps({"case": "/".join(c), "torch": torch.__version__,
                         **run(*c)})
             for c in peak_cases()]
    lines += [json.dumps({
        "case": f"full/mamba2-1.3b/{rules}", "torch": torch.__version__,
        "flops": head_full_port(rules),
        **run(FULL_HEAD, rules, "params_x", **FULL_SHAPE)})
        for rules in RULES]
    lines += [json.dumps({"case": f"full/{layer}/base",
                          "torch": torch.__version__,
                          **run(layer, "base", "params", **FULL_SHAPE)})
              for layer in FULL_ATTENTION]
    print("\n".join(lines))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
