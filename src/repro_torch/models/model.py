"""Model assembly: config, parameter init, forward, prefill, decode.

The port of ``src/repro/models/model.py``. The reference stacks each layer
group along a leading repeat axis and scans over it; here the ``Model``
holds one ``Block`` a layer in an ``nn.ModuleList``, in the reference's
layer order (``layer_slots``), and runs eagerly. Where autograd records
(training), each superblock (one repeat of a group's pattern, the body of
the reference's scan) is rematerialised in the backward pass under the
config's ``remat_policy``, as the reference checkpoints its scan body.

Embeddings are tied (logits = x @ embed.T). ``embed_inputs=True``
(VLM/audio stubs) takes pre-computed frontend embeddings instead of token
ids. The model carries its config, so the functions below take the model
where the reference takes ``(params, cfg)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import rms_norm, softcap, trunc_normal_
from repro_torch.sharding import constrain, get_mesh, replicate_plain

BLOCK_KINDS = ("attn", "attn_local", "attn_global", "moe", "moe_local",
               "ssm", "rec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig``, field for field; ``act_dtype`` is
    a ``torch.dtype``."""
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    block_pattern: tuple = ("attn",)
    first_dense: bool = False          # deepseek: layer 0 is dense
    # attention options
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    window: int | None = None          # local-attention window
    rope_theta: float = 10000.0
    attn_chunk: int = 1024
    heads_shardable: bool = True       # n_heads % tensor-parallel == 0
    mlp_act: str = "silu"              # "silu" (SwiGLU) | "gelu" (GeGLU)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"           # "einsum" | "sort"
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_bf16_intra: bool = False       # bf16 intra-chunk SSD tensors
    # RG-LRU
    rnn_width: int = 0
    rnn_conv: int = 4
    # modality
    embed_inputs: bool = False         # frontend stub feeds (B,S,D) embeds
    sub_quadratic: bool = False        # can run long_500k decode
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    # "nothing": full remat; "dots": save every matmul output without batch
    # dimensions; "blk_out": save only the named per-block outputs
    # (``attn_out``, ``ffn_out``).
    remat_policy: str = "nothing"
    norm_upcast: bool = True           # False: bf16 RMSNorm
    # The reference's dry run unrolls its layer scans with this set, since
    # XLA counts a loop body once. The port's layers are a Python loop
    # already, so it changes nothing here; the dry run still sets it.
    force_unroll: bool = False

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_groups(self):
        """[(pattern_tuple, n_repeats)] covering all n_layers."""
        n = self.n_layers - (1 if self.first_dense else 0)
        pat = self.block_pattern
        groups = []
        if self.first_dense:
            groups.append((("attn",), 1))
        n_super, rem = divmod(n, len(pat))
        if n_super:
            groups.append((pat, n_super))
        if rem:
            groups.append((pat[:rem], 1))
        return groups


def layer_slots(cfg: ModelConfig):
    """(group, repeat, pattern position, kind) of every layer, in layer
    order: group by group, then repeat by repeat, then pattern position."""
    return [(gi, rep, pi, kind)
            for gi, (pat, n_rep) in enumerate(cfg.layer_groups())
            for rep in range(n_rep)
            for pi, kind in enumerate(pat)]


def superblocks(cfg: ModelConfig):
    """(first, end) layer of every superblock, one repeat of a group's
    pattern, in layer order."""
    out, lo = [], 0
    for pat, n_rep in cfg.layer_groups():
        for _ in range(n_rep):
            out.append((lo, lo + len(pat)))
            lo += len(pat)
    return out


# ---------------------------------------------------------------------------
# Logical axes
# ---------------------------------------------------------------------------


def _block_axes(kind: str, cfg) -> dict:
    attn_ax = L.attention_axes(cfg)
    if kind.startswith("attn") or kind.startswith("moe"):
        out = {"ln1": (None,), "ln2": (None,), "attn": attn_ax}
        if kind.startswith("moe"):
            out["moe"] = L.moe_axes(cfg)
        else:
            out["mlp"] = L.mlp_axes()
        return out
    if kind == "ssm":
        return {"ln1": (None,), "ssm": L.ssm_axes()}
    if kind == "rec":
        return {"ln1": (None,), "rec": L.rglru_axes(),
                "ln2": (None,), "mlp": L.mlp_axes()}
    raise ValueError(kind)


def _stacked(tree):
    """Every axes tuple of ``tree`` with a leading None (the repeat axis)."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_logical_axes(cfg: ModelConfig) -> dict:
    """The reference's tree of parameter axes: the tree of its
    ``init_params``, leaves the logical axis tuples (stacked layer groups
    get a leading None for the repeat axis)."""
    return {"embed": ("vocab", "fsdp"), "ln_f": (None,),
            "groups": [_stacked({f"{pi}_{kind}": _block_axes(kind, cfg)
                                 for pi, kind in enumerate(pat)})
                       for pat, _ in cfg.layer_groups()]}


def _block_cache_axes(kind: str) -> dict:
    if _is_attn(kind):
        return L.attention_cache_axes()
    if kind == "ssm":
        return L.ssm_cache_axes()
    return L.rglru_cache_axes()


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """The reference's tree of cache axes (``init_cache``'s tree)."""
    return {"groups": [_stacked({f"{pi}_{kind}": _block_cache_axes(kind)
                                 for pi, kind in enumerate(pat)})
                       for pat, _ in cfg.layer_groups()],
            "index": ()}


def model_param_axes(model) -> dict:
    """``{port parameter name: logical axes}``, the reference's axes of
    the leaf that holds it, without the repeat axis."""
    cfg = model.cfg
    slots = layer_slots(cfg)
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = ("vocab", "fsdp") if name == "embed" else (None,)
            continue
        node = _block_axes(slots[int(parts[1])][3], cfg)
        for part in parts[2:]:
            node = node[part]
        out[name] = node
    return out


def model_placements(model) -> dict:
    """``{port parameter name: DTensor placements}`` of each parameter's
    logical axes on the installed mesh (``sharding.set_mesh``)."""
    from repro_torch.sharding import placements
    axes = model_param_axes(model)
    return {name: placements(axes[name], p.shape)
            for name, p in model.named_parameters()}


def replace_parameters(model, fn) -> None:
    """Replace each parameter of ``model``, in place, by
    ``nn.Parameter(fn(name, parameter))`` (the mesh's DTensors)."""
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module._parameters[attr] = nn.Parameter(fn(name, p),
                                                requires_grad=p.requires_grad)


def cache_axes(cfg: ModelConfig) -> list:
    """The logical axes of each layer's cache tensors, in layer order
    (``Cache.layers``)."""
    return [_block_cache_axes(kind) for *_, kind in layer_slots(cfg)]


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x`` (a copy) under a name
    that a remat policy can save by (``"blk_out"``)."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


@functools.cache
def _shard_checkpoint_name() -> None:
    """Give ``checkpoint_name`` a DTensor rule (once a process): it runs on
    each rank's shard and keeps the input's placements, so a remat policy
    still sees the op, with its name, under a mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.checkpoint_name.default)
    def _identity(x, name):
        return [([pl], [pl, None]) for pl in
                [Replicate(), Partial()] + [Shard(d) for d in range(x.ndim)]]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BLOCK_OUTPUTS = ("attn_out", "ffn_out")


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the
    products without batch dimensions (``x @ w``, which PyTorch runs as
    ``mm``); recompute batched products (``bmm``) and the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _save_block_outputs(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out", "ffn_out")``."""
    if op is torch.ops.repro_torch.checkpoint_name.default and \
            args[1] in _BLOCK_OUTPUTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"dots": _save_dots, "blk_out": _save_block_outputs}


def _superblock(blocks, x, tag):
    for block in blocks:
        x = block(x, tag=tag)
    return x


def _remat(blocks, x, policy: str):
    """The superblock ``blocks`` on ``x``, its activations recomputed in
    the backward pass but for what ``policy`` saves."""
    if policy == "nothing":
        return checkpoint(_superblock, blocks, x, None, use_reentrant=False)
    if policy not in _POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    tag = None
    if policy == "blk_out":
        tag = checkpoint_name
        if get_mesh() is not None:
            _shard_checkpoint_name()
    return checkpoint(_superblock, blocks, x, tag, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _POLICIES[policy]))


# ---------------------------------------------------------------------------
# Blocks and the model
# ---------------------------------------------------------------------------


def _is_attn(kind: str) -> bool:
    return kind.startswith("attn") or kind.startswith("moe")


class Block(nn.Module):
    """Pre-norm residual block of one kind (``BLOCK_KINDS``), holding the
    reference's leaves: ``ln1``, ``attn`` + ``mlp``/``moe`` + ``ln2``,
    ``ssm``, or ``rec`` + ``ln2`` + ``mlp``. Matmul weights take
    ``dtype`` (``None``: the activation dtype)."""

    def __init__(self, kind: str, cfg: ModelConfig, device=None,
                 dtype=None):
        super().__init__()
        if kind not in BLOCK_KINDS:
            raise ValueError(kind)
        self.kind, self.cfg = kind, cfg
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                            device=device))
        if _is_attn(kind):
            self.attn = L.Attention(cfg, device, dtype)
            if kind.startswith("moe"):
                self.moe = L.MoE(cfg, device, dtype)
            else:
                self.mlp = L.MLP(cfg, device=device, dtype=dtype)
        elif kind == "ssm":
            self.ssm = L.SSM(cfg, device, dtype)
        else:
            self.rec = L.RGLRU(cfg, device, dtype)
            self.mlp = L.MLP(cfg, device=device, dtype=dtype)
        if kind != "ssm":
            self.ln2 = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                                device=device))

    def reset_parameters(self, generator) -> None:
        """Zero norm scales and the reference's draws for the rest."""
        with torch.no_grad():
            for param in self.parameters(recurse=False):
                param.zero_()
        for child in self.children():
            child.reset_parameters(self.cfg, generator)

    def forward(self, x, cache=None, cache_index=None, tag=None):
        """Returns the block's output; ``cache`` is written in place.
        ``tag`` (``checkpoint_name``) names the attention and FFN outputs
        of an attention block for a remat policy."""
        cfg, kind = self.cfg, self.kind
        up = cfg.norm_upcast
        # The saved inter-block residual is D-sharded ("resid_embed");
        # "blk_in_embed" sets the sharding inside the block.
        x = constrain(x, "batch", None, "blk_in_embed")
        if _is_attn(kind):
            h = rms_norm(x, self.ln1, upcast=up)
            attn_out = L.attention_apply(self.attn, h, cfg,
                                         local=kind.endswith("local"),
                                         cache=cache, cache_index=cache_index)
            x = x + (attn_out if tag is None else tag(attn_out, "attn_out"))
            h = rms_norm(x, self.ln2, upcast=up)
            ffn = L.moe_apply(self.moe, h, cfg) if kind.startswith("moe") \
                else L.mlp_apply(self.mlp, h, cfg)
            x = x + (ffn if tag is None else tag(ffn, "ffn_out"))
            return constrain(x, "batch", "resid_seq", "resid_embed")
        state = None if cache is None else cache["state"]
        conv = None if cache is None else cache["conv"]
        h = rms_norm(x, self.ln1, upcast=up)
        apply = L.ssm_apply if kind == "ssm" else L.rglru_apply
        out, (new_state, new_conv) = apply(
            self.ssm if kind == "ssm" else self.rec, h, cfg, state, conv)
        x = x + out
        if kind == "rec":
            h = rms_norm(x, self.ln2, upcast=up)
            x = x + L.mlp_apply(self.mlp, h, cfg)
        if cache is not None:
            cache["state"].copy_(new_state)
            cache["conv"].copy_(new_conv)
        return constrain(x, "batch", "resid_seq", "resid_embed")


class Model(nn.Module):
    """Tied embedding ``embed (vocab, d)``, ``blocks`` in layer order and
    the final norm ``ln_f``. Built on ``device`` with uninitialised
    parameters; ``init_params`` draws them, ``convert.params_from_reference``
    loads the reference's. ``param_dtype`` is the dtype of the embedding
    and the matmul weights: ``None`` means the activation dtype (serving);
    training passes f32, the reference's masters."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.param_dtype = param_dtype or cfg.act_dtype
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab, cfg.d_model, dtype=self.param_dtype, device=device))
        self.ln_f = nn.Parameter(torch.empty(
            cfg.d_model, dtype=torch.float32, device=device))
        self.blocks = nn.ModuleList(
            Block(kind, cfg, device, self.param_dtype)
            for *_, kind in layer_slots(cfg))

    def reset_parameters(self, generator) -> None:
        """The reference's ``init_params`` distributions, drawn from
        ``generator`` (values differ from JAX's)."""
        trunc_normal_(self.embed, 1.0 / math.sqrt(self.cfg.d_model),
                      generator)
        with torch.no_grad():
            self.ln_f.zero_()
        for block in self.blocks:
            block.reset_parameters(generator)

    def forward(self, tokens_or_embeds, cache=None):
        """Logits (B, S, V); with ``cache``, a cached prefill or decode step
        that writes the cache and advances its index by S. Without a cache,
        where autograd records and ``cfg.remat`` is set, each superblock
        is rematerialised under ``cfg.remat_policy``."""
        cfg = self.cfg
        x = embed_tokens(self, tokens_or_embeds)
        if cache is None and cfg.remat and torch.is_grad_enabled():
            for lo, hi in superblocks(cfg):
                x = _remat(self.blocks[lo:hi], x, cfg.remat_policy)
        else:
            index = None if cache is None else cache.index
            for i, block in enumerate(self.blocks):
                x = block(x, None if cache is None else cache.layers[i],
                          index)
        logits = head_apply(x, self.ln_f, self.embed, cfg)
        if cache is not None:
            cache.index += x.shape[1]
        return logits


def head_apply(x, ln_f, embed, cfg):
    """The tied head: the final norm of the residual stream ``x`` (B, S,
    D) and its logits (B, S, V) against the embedding table ``embed`` (V,
    D), cast to x's dtype.

    Under a mesh the product is placed as the reference places it
    (``layers._project``): where ``model`` divides the vocab, vocab
    parallel on the gathered x; where it does not, a partial sum over x's
    split d_model, all-reduced, or (the sequence split, ``seq_sp``) the
    whole product on each rank from the gathered sequence. The table's
    gradient comes back on the table's placements, where the lookup's
    (``_lookup``) meets it."""
    x = rms_norm(x, ln_f, upcast=cfg.norm_upcast)
    (logits,) = L._project(x, [embed.to(x.dtype).T],
                           [("batch", None, "vocab")], logits=True)
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return constrain(logits, "batch", None, "vocab")


def init_params(cfg: ModelConfig, generator=None, device=None,
                param_dtype=None) -> Model:
    """A ``Model`` on ``device`` (``None``: the CUDA device) with weights
    drawn from ``generator`` (``None``: seed 0 on that device) in
    ``param_dtype`` (``Model``). The draws are f32 whatever the dtype, so
    f32 masters round to the weights a ``param_dtype=None`` model holds."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev, param_dtype=param_dtype)
    model.reset_parameters(generator)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_tokens(model: Model, tokens_or_embeds):
    """Token ids -> embeddings times sqrt(d_model) rounded to the activation
    dtype; frontend embeddings are cast to it."""
    cfg = model.cfg
    if cfg.embed_inputs:
        x = tokens_or_embeds.to(cfg.act_dtype)
    else:
        x = _lookup(model.embed.to(cfg.act_dtype), tokens_or_embeds)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype)
    return constrain(x, "batch", "resid_seq", "resid_embed")


def _lookup(table, tokens):
    """``table[tokens]``. On DTensors each rank indexes the whole table
    (gathered; its gradient reduce-scattered back) with its own tokens
    (``local_map``): DTensor's strategy for the index's backward
    (``index_put``) fails on some PyTorch releases, and this runs the
    plain op on one rank bit for bit."""
    if get_mesh() is None or not hasattr(table, "placements"):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    # Each rank's table gradient holds its own tokens' rows: a partial sum
    # over the mesh dims that split the tokens.
    grad = [Partial() if pl.is_shard() else Replicate()
            for pl in tokens.placements]
    return local_map(_index, out_placements=list(tokens.placements),
                     in_placements=([Replicate()] * mesh.ndim,
                                    list(tokens.placements)),
                     in_grad_placements=(grad, list(tokens.placements)),
                     device_mesh=mesh)(whole, tokens)


def _index(table, tokens):
    return table[tokens]


def forward(model: Model, tokens_or_embeds):
    """Training/scoring forward -> logits (B, S, V)."""
    return model(tokens_or_embeds)


# The loss upcasts the logits to f32 a block of token rows at a time: a
# block of at most this many bytes of f32.
NLL_BLOCK_BYTES = 1 << 28


def _row_blocks(n: int, rows: int) -> list:
    """[(start, stop)] of ``n`` rows in blocks of ``rows`` (at least 2). A
    last block of one row joins the one before it: on the CPU a sum over
    one row may be split over threads, where a sum over several rows is
    split between them, and a row would then add in another order."""
    bounds = list(range(0, n, max(2, rows))) + [n]
    if len(bounds) > 2 and bounds[-1] - bounds[-2] == 1:
        del bounds[-2]
    return list(zip(bounds[:-1], bounds[1:]))


class _NLL(torch.autograd.Function):
    """Per-token ``logsumexp(x) - x[label]`` over the last dim of the
    logits ``x`` in f32, whatever their dtype: each block of token rows
    (``_row_blocks``) is upcast in turn, so one f32 copy of the logits is
    never made; the forward saves the logits and ``lse``, and the backward
    writes ``g * exp(x - lse)`` block by block into the gradient, in the
    logits' dtype. The ops are ``torch.logsumexp``'s and its backward's
    (``log(sum(exp(x - max))) + max``; ``g * exp(x - lse)``) on the same
    elements of each row, so it is the plain ``logsumexp - gather`` of f32
    logits bit for bit.

    With a ``group``, each of its ranks holds the vocab slice ``[lo, lo +
    V_local)``: the max and the sum of exponentials are all-reduced and the
    gold logit summed from the rank that holds it, so the logits are never
    gathered."""

    @staticmethod
    def forward(ctx, x, labels, group, lo, block_rows):
        from torch.distributed import _functional_collectives as funcol
        f32 = torch.float32
        v = x.shape[-1]
        x2 = x.reshape(-1, v)
        local = labels.reshape(-1) - lo
        blocks = _row_blocks(x2.shape[0], block_rows)
        m = torch.amax(x2, -1, keepdim=True).to(f32)
        if group is not None:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = torch.cat([torch.sum(torch.sub(x2[i:j], m[i:j]).exp_(), -1)
                       for i, j in blocks])
        if group is not None:
            s = funcol.wait_tensor(funcol.all_reduce(s, "sum", group))
        lse = torch.log(s) + m[:, 0]
        inside = None
        if group is not None:
            inside = (local >= 0) & (local < v)
            local = local.clamp(0, v - 1)
        gold = torch.gather(x2, -1, local[:, None])[:, 0].to(f32)
        if group is not None:
            gold = funcol.wait_tensor(funcol.all_reduce(
                torch.where(inside, gold, 0.0), "sum", group))
        ctx.save_for_backward(x, lse, local, inside)
        ctx.blocks = blocks
        return (lse - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, lse, local, inside = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g = g.reshape(-1)
        gold = -g if inside is None else torch.where(inside, -g, 0.0)
        grad = torch.empty_like(x2)
        buf = None if grad.dtype == torch.float32 else grad.new_empty(
            (max(j - i for i, j in ctx.blocks), x2.shape[1]),
            dtype=torch.float32)
        for i, j in ctx.blocks:
            out = grad[i:j] if buf is None else buf[:j - i]
            torch.sub(x2[i:j], lse[i:j, None], out=out)
            out.exp_().mul_(g[i:j, None])
            out.scatter_add_(-1, local[i:j, None], gold[i:j, None])
            if buf is not None:
                grad[i:j] = out
        return grad.reshape(x.shape), None, None, None, None


def _nll(logits, labels):
    """Per-token ``logsumexp - gold`` of the logits in f32 (``_NLL``, in
    blocks of ``NLL_BLOCK_BYTES`` of f32). On DTensors each rank runs it
    on its shards (``local_map``): vocab-sharded logits stay sharded (each
    rank on its slice), as the reference's sharded logsumexp does; logits
    whole on the vocab on each rank's rows (DTensor's strategy for the
    gold gather's backward builds the global batch's logits on some
    releases)."""
    block_rows = NLL_BLOCK_BYTES // (4 * logits.shape[-1])
    mesh = get_mesh()
    if mesh is None or not hasattr(logits, "placements"):
        return _NLL.apply(logits, labels, None, 0, block_rows)
    from torch.distributed.tensor.experimental import local_map
    vocab_dims = [i for i, pl in enumerate(logits.placements)
                  if pl.is_shard(logits.ndim - 1)]
    group, lo = None, 0
    if vocab_dims:
        (dim,) = vocab_dims
        group = mesh.get_group(dim)
        lo = mesh.get_local_rank(dim) * (logits.shape[-1] // mesh.size(dim))
    fn = functools.partial(_nll_local, group=group, lo=lo,
                           block_rows=block_rows)
    return local_map(fn, out_placements=list(labels.placements),
                     in_placements=(list(logits.placements),
                                    list(labels.placements)),
                     device_mesh=mesh)(logits, labels)


def _nll_local(x, labels, group, lo, block_rows):
    return _NLL.apply(x, labels, group, lo, block_rows)


def loss_fn(model: Model, batch: dict):
    """Mean next-token cross-entropy (f32 logsumexp, the logits upcast a
    block of rows at a time; over vocab-sharded logits under a mesh)."""
    cfg = model.cfg
    inputs = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    logits = forward(model, inputs)
    labels = batch["labels"].long()
    mask = batch.get("mask")
    nll = _nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(nll.numel())
    return nll.sum() / denom


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cache:
    """Each layer's cache tensors (a dict, in layer order), written in
    place, and ``index``: the position of the next token, shared by every
    slot."""
    layers: list
    index: int = 0


def _block_cache(kind, cfg, batch, max_len, dtype, device):
    if _is_attn(kind):
        return L.attention_cache(cfg, batch, max_len, dtype,
                                 local=kind.endswith("local"), device=device)
    if kind == "ssm":
        return L.ssm_cache(cfg, batch, dtype, device)
    return L.rglru_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    """Zeroed caches of every layer on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    return Cache([_block_cache(kind, cfg, batch, max_len, cfg.act_dtype, dev)
                  for *_, kind in layer_slots(cfg)])


@torch.no_grad()
def prefill(model: Model, tokens_or_embeds, cache: Cache):
    """Process a prompt batch, filling the cache. Returns (logits, cache)."""
    with replicate_plain():
        return model(tokens_or_embeds, cache), cache


@torch.no_grad()
def decode_step(model: Model, token_or_embed, cache: Cache):
    """One token per sequence: (B,) ids or (B,1,D) embeds."""
    if not model.cfg.embed_inputs and token_or_embed.ndim == 1:
        token_or_embed = token_or_embed[:, None]
    with replicate_plain():
        return model(token_or_embed, cache), cache
