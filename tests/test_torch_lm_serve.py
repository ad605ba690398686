"""The port's LM serving engine (``repro_torch.serve.engine``) against the
reference's on the CPU: qwen3's smoke config in f32 with the reference's
weights carried across (its MLP output projections scaled so that greedy
decoding moves, see ``RESID_SCALE``); both engines must emit the same
greedy tokens and count the same prefills and decode steps in
``tests/test_serve.py``'s two scenarios and in one with unequal prompt
lengths (left padding) and more requests than slots. Also the engine's and
the weight carry-over's refusals, and the serving CLI on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config as ref_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.engine import Request, ServeEngine


# The MLP output projections (w2) are scaled by this power of two after the
# reference's init, so that each block's MLP, a function of the current
# token, outweighs both the tied embedding and the attention's average over
# the context in the residual stream, and greedy decoding moves on from
# token to token. At the init's scale every request repeats its first
# generated token, and equal tokens would test little beyond one argmax.
RESID_SCALE = 32.0


def _moving(params):
    def scale(path, leaf):
        return leaf * RESID_SCALE if getattr(path[-1], "key", None) == "w2" \
            else leaf
    return jax.tree_util.tree_map_with_path(scale, params)


@pytest.fixture(scope="module")
def qwen3():
    rcfg = dataclasses.replace(ref_config("qwen3-0.6b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype="float32")
    params = _moving(jax.jit(lambda k: R.init_params(rcfg, k))(
        jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return rcfg, params, cfg, tree


# (seed, prompt lengths, max_new_tokens per request, slots, max_len)
SCENARIOS = {
    "equal_lengths": (0, (12, 12, 12), (6, 6, 6), 3, 128),
    "refill_more_requests_than_slots": (1, (8,) * 5, (4,) * 5, 2, 64),
    "unequal_lengths_left_padded": (2, (5, 11, 8, 14, 3, 9),
                                    (3, 6, 4, 2, 5, 4), 2, 64),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_emits_reference_tokens(scenario, qwen3):
    rcfg, params, cfg, tree = qwen3
    seed, lengths, max_new, slots, max_len = SCENARIOS[scenario]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in lengths]
    ref = RefEngine(rcfg, params, batch_slots=slots, max_len=max_len)
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
    ref.generate(ref_reqs)
    engine = ServeEngine(params_from_reference(tree, cfg, device="cpu"),
                         batch_slots=slots, max_len=max_len, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    assert engine.generate(reqs) is reqs
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert all(len(set(r.out_tokens)) > 1 for r in reqs)  # decoding moves
    assert all(r.done and len(r.out_tokens) == n
               for r, n in zip(reqs, max_new))
    for key in ("prefills", "decode_steps"):
        assert engine.last_stats[key] == ref.last_stats[key], key
    if scenario != "equal_lengths":
        assert engine.last_stats["prefills"] >= 3  # refilled at least twice


def test_engine_needs_cuda_without_a_device(qwen3, monkeypatch):
    *_, cfg, tree = qwen3
    model = params_from_reference(tree, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model)


def test_engine_refuses_embedding_models():
    from repro_torch.models.model import Model
    cfg = get_config("musicgen-medium", smoke=True)
    with pytest.raises(ValueError, match="token models"):
        ServeEngine(Model(cfg, device="meta"), device="cpu")


def _drop(tree, path):
    *head, last = path
    node = tree
    for key in head:
        node = node[key]
    del node[last]


@pytest.mark.parametrize("fault", ["missing_leaf", "extra_leaf",
                                   "wrong_shape", "missing_block"])
def test_params_from_reference_rejects_bad_trees(fault, qwen3):
    *_, cfg, tree = qwen3
    bad = jax.tree_util.tree_map(lambda a: a, tree)  # a fresh nested copy
    block = bad["groups"][0]["0_attn"]
    if fault == "missing_leaf":
        _drop(bad, ("groups", 0, "0_attn", "attn", "wk"))
    elif fault == "extra_leaf":
        block["mlp"]["w4"] = block["mlp"]["w1"]
    elif fault == "wrong_shape":
        block["ln2"] = block["ln2"][:, :-1]
    else:
        _drop(bad, ("groups", 0, "0_attn"))
    error = ValueError if fault == "wrong_shape" else KeyError
    with pytest.raises(error):
        params_from_reference(bad, cfg, device="cpu")
    params_from_reference(tree, cfg, device="cpu")  # the original loads


def test_serve_cli_on_the_cpu(capsys):
    stats = serve_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", "--requests", "3", "--slots", "2",
                            "--max-new", "4", "--max-len", "64"])
    assert stats["tokens"] == 12 and stats["prefills"] == 2
    assert "tok/s on cpu" in capsys.readouterr().out


def test_serve_cli_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--smoke"])
