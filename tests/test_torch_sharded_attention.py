"""The mesh attention keeps the query heads sharded where the mesh dim that
splits them does not divide the kv heads (``models/layers.py::_attention``):
each rank attends its H / M contiguous heads with the kv heads they read.

(a) On plain tensors: M simulated ranks' head slices, attended with the
    whole K/V and concatenated, equal the whole heads' attention bit for
    bit.
(b) On a (2, 2) gloo mesh of four spawned ranks, qwen3's smoke config with
    one kv head (so ``model`` = 2 does not divide it): each rank's q has
    H / 2 heads; the output and the gradients of ``wq``/``wk``/``wv``/``wo``
    and of the input equal the unsharded port's and the reference's
    ``attention_apply`` (``jax.value_and_grad``) at rtol 1e-5, with an
    absolute floor of 1e-5 of each tensor's largest magnitude (f32; the
    mesh sums the K/V gradients' partial sums, the tokens' data shards and
    the residual stream's d_model shards in another order, so elements
    near zero carry the rounding of their large terms).
(c) qwen3-0.6b's ``train_4k`` dry run on (data 16, model 16), cut to one
    layer: the attention's per-device ``bmm`` FLOPs are exactly 1/256 of
    the analytic attention count, one head of 16 sequences a rank (the
    full-depth cell's counts are in PERF.md).
"""
import dataclasses
import datetime
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference

B, S = 4, 32
RTOL = 1e-5
DEADLINE_S = 180


@pytest.mark.parametrize("h,hkv,m", [(16, 8, 16), (12, 3, 2), (4, 1, 2),
                                     (4, 2, 4)])
def test_rank_head_slices_equal_whole_attention(h, hkv, m):
    rng = np.random.default_rng(h * 100 + hkv * 10 + m)
    dh = 8
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, S, n, dh)).astype(np.float32)) for n in (h, hkv, hkv))
    pos = torch.arange(S, dtype=torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos, window=None, cap=None,
              chunk=16)
    whole = L._chunked_attention(q.reshape(2, S, hkv, h // hkv, dh), k, v,
                                 **kw).reshape(2, S, h, dh)
    n = h // m
    got = torch.cat([L._grouped_attention(q[:, :, r * n:(r + 1) * n], k, v,
                                          g=h // hkv, q_lo=r * n, **kw)
                     for r in range(m)], dim=2)
    assert torch.equal(got, whole)


def _cfgs():
    kw = dict(dtype="float32", n_kv=1)
    return (dataclasses.replace(ref_config("qwen3-0.6b", smoke=True), **kw),
            dataclasses.replace(get_config("qwen3-0.6b", smoke=True), **kw))


def _reference_inputs():
    """The reference's layer-0 attention leaves (q/k norms drawn, not
    zero), the input and the output's cotangent, as NumPy arrays."""
    rcfg, _ = _cfgs()
    tree = R.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    attn = tree["groups"][0]["0_attn"]["attn"]
    for name in ("q_norm", "k_norm"):
        attn[name] = 0.3 * rng.standard_normal(attn[name].shape).astype(
            np.float32)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    return tree, {k: np.asarray(v)[0] for k, v in attn.items()}, x, ct


def _port_attention(tree, cfg):
    """Block 0's attention module of the port's model holding ``tree``."""
    return params_from_reference(tree, cfg, device="cpu").blocks[0].attn


def _run(module, cfg, x, ct, params):
    """(output, gradients of ``params`` and of ``x``) of the loss
    ``sum(attention_apply(x) * ct)``."""
    out = L.attention_apply(module, x, cfg, local=False)
    grads = torch.autograd.grad((out * ct).sum(), params + [x])
    return out, grads


GRADS = ("wq", "wk", "wv", "wo")


def _mesh_rank(rank: int, world: int, init_file: str, root: str):
    """One of four ranks on the (2, 2) debug mesh: the attention with its
    parameters, input and cotangent sharded by their logical axes; rank 0
    saves the gathered output and gradients and the q head counts seen."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import arch_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import placements, replicate_plain, set_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    heads = []
    local = L._grouped_attention

    def recording(q, *args, **kw):
        heads.append(q.shape[2])
        return local(q, *args, **kw)

    try:
        mesh = make_debug_mesh()
        _, cfg = _cfgs()
        set_mesh(mesh, arch_rules(cfg, 2))
        L._grouped_attention = recording
        tree, _, x, ct = _reference_inputs()
        module = _port_attention(tree, cfg)
        axes = L.attention_axes(cfg)
        for name, p in list(module.named_parameters()):
            setattr(module, name, torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, placements(axes[name], p.shape))))
        xd = distribute_tensor(torch.from_numpy(x), mesh,
                               placements(("batch", None, "blk_in_embed"),
                                          x.shape)).requires_grad_()
        with replicate_plain():
            out = L.attention_apply(module, xd, cfg, local=False)
            ctd = distribute_tensor(torch.from_numpy(ct), mesh,
                                    out.placements)
            grads = torch.autograd.grad(
                (out * ctd).sum(),
                [getattr(module, n) for n in GRADS] + [xd])
        got = {"out": out.full_tensor().detach(),
               "grads": [g.full_tensor() for g in grads],
               "q_placements": [repr(p) for p in placements(
                   ("batch", None, "heads", None), (B, S, cfg.n_heads, 1))],
               "heads": heads}
        if rank == 0:
            torch.save(got, os.path.join(root, "mesh.pt"))
    finally:
        L._grouped_attention = local
        set_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def _mesh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_attention"))
    ctx = torch.multiprocessing.spawn(
        _mesh_rank, args=(4, os.path.join(root, "init"), root), nprocs=4,
        join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the mesh ranks did not finish in {DEADLINE_S} s")
    return torch.load(os.path.join(root, "mesh.pt"))


def _plain():
    _, cfg = _cfgs()
    tree, _, x, ct = _reference_inputs()
    module = _port_attention(tree, cfg)
    xt = torch.from_numpy(x).requires_grad_()
    out, grads = _run(module, cfg, xt, torch.from_numpy(ct),
                      [getattr(module, n) for n in GRADS])
    return out.detach(), [g.detach() for g in grads]


def _reference():
    rcfg, _ = _cfgs()
    _, p, x, ct = _reference_inputs()

    def loss(p, x):
        out = RL.attention_apply(p, x, rcfg, local=False)[0]
        return (out * ct).sum(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    return np.asarray(out), [np.asarray(gp[n]) for n in GRADS] + \
        [np.asarray(gx)]


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


def test_mesh_attention_keeps_query_heads_sharded(_mesh):
    """Each rank's q shard holds H / 2 of qwen3's 4 heads (the forward
    and the remat-free backward never see a whole q), the heads are
    sharded on ``model`` and every attention call saw them."""
    _, cfg = _cfgs()
    assert "Shard(dim=2)" in _mesh["q_placements"]
    assert _mesh["heads"] and set(_mesh["heads"]) == {cfg.n_heads // 2}


def test_mesh_attention_matches_unsharded_port(_mesh):
    """The output and the gradients of wq/wk/wv/wo and the input: the K/V
    gradients are the ranks' partial sums, declared ``Partial``."""
    out, grads = _plain()
    _close(_mesh["out"], out, "out")
    for name, got, want in zip(GRADS + ("x",), _mesh["grads"], grads):
        _close(got, want, name)


def test_mesh_attention_matches_reference(_mesh):
    """One attention layer's forward and backward against the reference's
    ``attention_apply`` on the same weights (``params_from_reference``)."""
    out, grads = _reference()
    _close(_mesh["out"], out, "out")
    for name, got, want in zip(GRADS + ("x",), _mesh["grads"], grads):
        _close(got, want, name)


def test_train_4k_attention_flops_per_device():
    """qwen3-0.6b's train_4k (256 x 4096) on (data 16, model 16), one
    layer: the attention's QK and PV products (the step's only ``bmm``s)
    count 4 x (forward, recompute, 2 backward) x 2 x 2 x B x H x S^2 x
    dh / 256 FLOPs per device: 16 sequences and 1 of 16 heads a rank."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S_
    bmm = {"flops": 0}
    dispatch = D.DeviceCost.__torch_dispatch__

    def counting(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = dispatch(self, func, types, args, kwargs)
        if func._overloadpacket is torch.ops.aten.bmm:
            bmm["flops"] += self.flops - before
        return out

    D.DeviceCost.__torch_dispatch__ = counting
    try:
        res = D.run_cell("qwen3-0.6b", "train_4k", multi_pod=False,
                         n_layers=1)
    finally:
        D.DeviceCost.__torch_dispatch__ = dispatch
    assert res.get("ok"), res.get("error")
    cfg, info = get_config("qwen3-0.6b"), S_.SHAPES["train_4k"]
    attention = 4 * 2 * 2 * info["batch"] * cfg.n_heads * info["seq"] ** 2 \
        * cfg.head_dim
    assert bmm["flops"] == attention // 256
