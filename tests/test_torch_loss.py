"""The LM loss's tail (``models/model.py::_NLL``, ``loss_fn``): per-token
``logsumexp - gold`` in f32 over logits of any dtype, upcast a block of
token rows at a time.

* Bit for bit, value and gradient, against the plain ``torch.logsumexp -
  gather`` of the logits upcast whole (the loss before the blocks), f32 and
  bf16 logits, with and without a mask, in one block, in blocks whose last
  one is partial, and in blocks of two rows over an odd row count (a last
  row joins the block before it).
* Against the reference's ``loss_fn`` (its forward replaced by the
  logits), at ``tests/test_torch_train_step.py``'s tolerances: the loss at
  rtol 1e-6, the gradient within 3e-5 of its largest magnitude (bf16:
  2^-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import model as M

B, S, V = 3, 37, 300          # 111 rows: no block size below divides them
LOSS_RTOL, GRAD_TOL, BF16_TOL = 1e-6, 3e-5, 2.0 ** -9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(dtype: str, masked: bool):
    """Seeded logits (some rows with -inf entries), labels and mask."""
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((B, S, V)) * 4).astype(np.float32)
    logits[0, 0, :7] = -np.inf
    logits[1, 2, 5:40] = -np.inf
    labels = rng.integers(0, V, (B, S))
    labels[0, 0] = 9
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    return (torch.from_numpy(logits).to(DTYPES[dtype]),
            torch.from_numpy(labels), mask)


def _port_loss(logits, labels, mask, monkeypatch):
    """``M.loss_fn`` on ``logits``: the model's forward returns them."""
    monkeypatch.setattr(M, "forward", lambda model, inputs: logits)
    model = type("Model", (), {"cfg": get_config("qwen3-0.6b", smoke=True)})
    batch = {"tokens": labels, "labels": labels}
    if mask is not None:
        batch["mask"] = torch.from_numpy(mask)
    return M.loss_fn(model, batch)


def _plain_loss(logits, labels, mask):
    """The loss with the logits upcast whole: ``torch.logsumexp - gather``
    and autograd."""
    x = logits.float()
    nll = torch.logsumexp(x, dim=-1) - torch.gather(
        x, -1, labels[..., None])[..., 0]
    if mask is None:
        return nll.sum() / float(nll.numel())
    mask = torch.from_numpy(mask)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("block_rows", [None, 16, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_bit_for_bit_plain(dtype, masked, block_rows, monkeypatch):
    if block_rows is not None:
        monkeypatch.setattr(M, "NLL_BLOCK_BYTES", 4 * V * block_rows)
    logits, labels, mask = _inputs(dtype, masked)
    x = logits.clone().requires_grad_()
    got = _port_loss(x, labels, mask, monkeypatch)
    (got_grad,) = torch.autograd.grad(got, x)
    y = logits.clone().requires_grad_()
    want = _plain_loss(y, labels, mask)
    (want_grad,) = torch.autograd.grad(want, y)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got_grad.dtype == logits.dtype
    assert torch.equal(got_grad, want_grad)


def test_row_blocks_cover_rows_once():
    """Blocks of ``rows`` rows over ``n``, none of one row unless n is 1."""
    for n in range(1, 40):
        for rows in range(1, 12):
            blocks = M._row_blocks(n, rows)
            assert blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            assert all(j - i >= 2 for i, j in blocks) or n == 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_matches_reference(dtype, masked, monkeypatch):
    logits, labels, mask = _inputs(dtype, masked)
    x = logits.clone().requires_grad_()
    got = _port_loss(x, labels, mask, monkeypatch)
    (got_grad,) = torch.autograd.grad(got, x)

    rcfg = ref_config("qwen3-0.6b", smoke=True)
    monkeypatch.setattr(RM, "forward", lambda params, cfg, inputs: params)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_logits = jnp.asarray(logits.float().numpy()).astype(jdt)
    batch = {"tokens": jnp.asarray(labels.numpy()),
             "labels": jnp.asarray(labels.numpy())}
    if mask is not None:
        batch["mask"] = jnp.asarray(mask)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b)))(ref_logits, batch)
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    want_grad = np.asarray(want_grad.astype(jnp.float32))
    tol = (BF16_TOL if dtype == "bfloat16" else GRAD_TOL) \
        * np.abs(want_grad).max()
    np.testing.assert_allclose(got_grad.float().numpy(), want_grad, rtol=0,
                               atol=tol)
