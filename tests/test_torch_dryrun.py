"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
counterparts of ``tests/test_dryrun.py``'s cells, and its counting rules.

Cells are cut in depth (``n_layers``, stated in each test; widths and
input shapes are the published ones) so that the file stays near a
minute on one worker. Each cell runs under a fake process group of its
mesh's size in this process, but the mistral one, which runs in a
subprocess whose peak RSS is read around the trace."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; it sets ``XLA_FLAGS`` when
    imported, so the backend is started first and the variable put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return dryrun


def test_debug_mesh_decode_cell_multi_pod():
    """qwen3-0.6b decode_32k on the (2, 2, 2) debug mesh, cut to 2 layers:
    ok, with collectives, per-device numbers."""
    res = D.run_cell("qwen3-0.6b", "decode_32k", multi_pod=True,
                     debug_mesh=True, n_layers=2)
    assert res.get("ok"), res.get("error")
    assert res["n_devices"] == 8 and res["mesh"] == [2, 2, 2]
    assert res["collectives"], "expected collectives"
    assert res["cost_analysis"]["flops"] > 0
    mem = res["memory_analysis"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["parameters"] > 0 and mem["gradients"] == 0


def test_train_cell_counts_wire_bytes_and_allocates_nothing(tmp_path):
    """mistral-nemo-12b train_4k on the (2, 2) debug mesh, cut to 2 of its
    40 layers, in a subprocess: wire bytes above 0; its per-device state
    (3.6 GB of f32 masters and moments at 2 layers, a quarter of the
    model's) and activations are fake, so the process's peak RSS grows by
    less than 1 GB over the trace."""
    code = textwrap.dedent("""
        import json, resource, sys
        from repro_torch.launch import dryrun as D
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        res = D.run_cell("mistral-nemo-12b", "train_4k", multi_pod=False,
                         debug_mesh=True, n_layers=2)
        after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        res["rss_growth_bytes"] = (after - before) * 1024
        print(json.dumps(res))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res.get("ok"), res.get("error")
    wire = sum(v["wire_bytes_per_device"] for v in res["collectives"].values())
    assert wire > 0, res["collectives"]
    mem = res["memory_analysis"]
    assert mem["optimizer_state"] == 2 * mem["parameters"] > 2e9
    assert mem["peak_bytes"] > 1e10
    assert res["rss_growth_bytes"] < 1e9, res["rss_growth_bytes"]


@pytest.mark.parametrize("kind,g", [("all-gather", 2), ("all-gather", 16),
                                    ("all-reduce", 2), ("all-reduce", 16),
                                    ("reduce-scatter", 8),
                                    ("all-to-all", 4),
                                    ("collective-permute", 2)])
def test_ring_factors_match_reference_parser(kind, g, ref_dryrun):
    """``wire_bytes`` against the reference's ``parse_collectives`` on one
    collective of a (64, 128) bf16 result over a group of g."""
    line = (f"  %c = bf16[64,128]{{1,0}} {kind}(bf16[64,128]{{1,0}} %x), "
            f"replica_groups=[{16 // g if g <= 16 else 1},{g}]<=[16]")
    want = ref_dryrun.parse_collectives(line)[kind]
    assert want["count"] == 1 and want["result_bytes"] == 64 * 128 * 2
    assert D.wire_bytes(kind, 64 * 128 * 2, g) == \
        want["wire_bytes_per_device"]


def test_combine_costs_matches_reference(ref_dryrun):
    full = {"ok": True, "n_devices": 4, "memory_analysis": {"a": 1},
            "cost_analysis": {"flops": 10.0, "bytes accessed": 7.0},
            "collectives": {"all-gather": {"count": 2,
                                           "wire_bytes_per_device": 5.0}},
            "trace_s": 1.0, "compile_s": 1.0}
    u1 = dict(full, cost_analysis={"flops": 11.0, "bytes accessed": 9.0})
    u2 = dict(full, cost_analysis={"flops": 15.0, "bytes accessed": 10.0},
              collectives={"all-gather": {"count": 5,
                                          "wire_bytes_per_device": 9.0},
                           "all-reduce": {"count": 1,
                                          "wire_bytes_per_device": 3.0}})
    got = D._combine_costs(full, u1, u2, 7)
    want = ref_dryrun._combine_costs(full, u1, u2, 7)
    for key in ("cost_analysis", "collectives", "n_devices",
                "memory_analysis", "ok", "method", "n_super"):
        assert got[key] == want[key], key


def test_u1_u2_extrapolation_equals_full_depth_count():
    """The port counts every layer, so U1 + (n - 1) (U2 - U1) over n = 4
    superblocks of qwen3 (decode_32k on the (2, 2) debug mesh) is the
    4-layer cell's count, FLOPs, bytes and collectives alike."""
    u1, u2, full = (D.run_cell("qwen3-0.6b", "decode_32k", False,
                               debug_mesh=True, unrolled=True, n_layers=n)
                    for n in (1, 2, 4))
    assert u1["ok"] and u2["ok"] and full["ok"]
    out = D._combine_costs(u1, u1, u2, 4)
    assert out["cost_analysis"] == full["cost_analysis"]
    for kind, rec in full["collectives"].items():
        assert out["collectives"][kind]["count"] == rec["count"]
        assert out["collectives"][kind]["wire_bytes_per_device"] == \
            pytest.approx(rec["wire_bytes_per_device"], rel=1e-12)


def test_smoke_train_step_flops_equal_analytic_count():
    """The chip smoke's train step (qwen3-0.6b at full width, batch 8 x
    128, remat "nothing"), cut to 2 layers, on a one-device mesh: the
    traced matmul FLOPs are ``analytic_train_flops`` exactly, and the
    peak holds the f32 masters, their gradients and both moments."""
    import dataclasses
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    with D.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        res = D.trace_cell(cfg, {"kind": "train", "seq": 128, "batch": 8},
                           mesh, D.arch_rules(cfg, 1))
    assert res["cost_analysis"]["flops"] == D.analytic_train_flops(cfg, 8,
                                                                   128)
    mem = res["memory_analysis"]
    n = sum(p.numel() for p in Model(cfg, device="meta").parameters())
    assert mem["parameters"] == mem["gradients"] == 4 * n
    assert mem["optimizer_state"] == 8 * n
    assert mem["peak_bytes"] >= 16 * n


def test_cli_writes_cells_and_roofline_reads_them(tmp_path, monkeypatch):
    """``main`` writes one JSON per cell under the reference's names (a
    skipped long_500k included) and caches them; the roofline reads one."""
    from repro_torch.bench import roofline
    monkeypatch.setattr(D, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    orig = D.run_cell
    monkeypatch.setattr(D, "run_cell", lambda *a, **k: orig(
        *a, **dict(k, n_layers=1)))
    rc = D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--single-pod", "--debug-mesh"])
    assert rc == 0
    cell = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single_pod.json")
                      .read_text())
    assert cell["ok"] and cell["n_layers"] == 1
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                   "--single-pod", "--debug-mesh"]) == 0
    assert json.loads((tmp_path / "qwen3-0.6b__long_500k__single_pod.json")
                      .read_text())["skipped"]
    r = roofline.analyze("qwen3-0.6b", "decode_32k")
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["n_devices"] == 4 and r["cost_source"] == "full depth"


def test_device_cost_counts_each_storage_once():
    """A collective's wrapped result (``_wrap_tensor_autograd``) holds its
    input in eager, so ``DeviceCost`` counts no new storage for it (its
    fake kernel makes one), nor bytes for a device query."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    wrap = torch.ops._c10d_functional._wrap_tensor_autograd
    x = torch.randn(4, 8)
    assert wrap(x).elem is x
    with FakeTensorMode():
        x = torch.empty(64, 128)
    cost = D.DeviceCost()
    cost.register([x], "arguments")
    with cost:
        assert wrap(x) is x
        torch.ops.prim.device(x)
    assert cost.peak == 64 * 128 * 4
    assert cost.bytes == 0
