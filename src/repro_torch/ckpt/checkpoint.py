"""Fault-tolerant checkpointing.

The port of ``src/repro/ckpt/checkpoint.py``, with the same on-disk
contract:

  * atomic commits: write to ``step_XXXXXXXXXX.tmp/``, fsync, rename — a
    crash mid-save never corrupts the latest valid checkpoint;
  * integrity: one ``.npy`` per leaf, named by the md5 of its key, and its
    sha256 in ``manifest.json``; restore verifies and *skips back* past
    corrupt, partial or mismatched checkpoints;
  * keep-last-k garbage collection;
  * async save: the state is copied to host memory synchronously (so
    training may update it in place at once) and serialised on a worker
    thread; a worker's error is raised at the next ``wait()``.

A ``TrainState`` is saved in the reference's layout and under its keys
(``.params/groups/0/0_attn/attn/wq``, ``.opt/mu/...``, ``.step``): each
leaf of a layer group stacked along its repeat axis
(``convert.reference_leaves``), so the two packages read each other's
checkpoints. Restore takes the ``device`` to load onto.

Elastic restore: a sharded state (DTensors on an installed mesh) is saved
in logical, unsharded form (every rank joins the gather; rank 0 writes),
so it restores onto any mesh, or none: ``restore(placements=...)`` lays
each tensor out on the installed mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import Model
from repro_torch.sharding import get_mesh
from repro_torch.train.step import TrainState


def _full(t):
    """``t`` whole on this rank: a DTensor is gathered (a collective every
    rank must join)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _writer() -> bool:
    """Rank 0 writes; every rank reads."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _leaves(state):
    """(key, [tensors], stacked) of every leaf of ``state`` (a
    ``TrainState``) in the reference's layout."""
    model = state.params
    leaves = reference_leaves(model.cfg)
    groups = [(".params", dict(model.named_parameters()))]
    groups += [(f".opt/{k}", state.opt[k]) for k in sorted(state.opt)]
    return [(f"{prefix}/{leaf.key}", [tensors[n] for n in leaf.names],
             leaf.stacked)
            for prefix, tensors in groups for leaf in leaves]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self._last_error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save

    def save(self, step: int, state, blocking: bool = False):
        """Snapshot to host memory synchronously; serialize async. Under
        a mesh every rank must call it (the gather); rank 0 writes."""
        self.wait()  # one in-flight save at a time
        host = [(key, [_full(t.detach()).to("cpu", copy=True) for t in ts],
                 stacked) for key, ts, stacked in _leaves(state)]
        if not _writer():
            return
        host.append((".step", [torch.tensor(int(state.step),
                                            dtype=torch.int32)], False))
        if self.async_save and not blocking:
            self._worker = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._worker.start()
        else:
            self._write(step, host)

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _write(self, step: int, host):
        try:
            final = os.path.join(self.dir, f"step_{step:010d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "arrays": {}, "time": time.time()}
            for key, tensors, stacked in host:
                arrays = [t.numpy() for t in tensors]
                arr = np.stack(arrays) if stacked else arrays[0]
                fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
                path = os.path.join(tmp, fname)
                with open(path, "wb") as fh:
                    np.save(fh, arr)
                    fh.flush()
                    os.fsync(fh.fileno())
                with open(path, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
                manifest["arrays"][key] = {
                    "file": fname, "sha256": digest,
                    "shape": list(arr.shape), "dtype": str(arr.dtype)}
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath, "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
        except Exception as exc:  # noqa: BLE001 — surfaced on next wait()
            self._last_error = exc

    def _gc(self):
        steps = self.all_steps()
        for step in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{step:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _verify(self, path: str) -> dict | None:
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
            for key, info in manifest["arrays"].items():
                fpath = os.path.join(path, info["file"])
                with open(fpath, "rb") as fh:
                    if hashlib.sha256(fh.read()).hexdigest() != info["sha256"]:
                        return None
            return manifest
        except (OSError, ValueError, KeyError):
            return None

    def restore(self, like, step: int | None = None, device=None,
                placements: dict | None = None):
        """Restore into the structure of ``like`` (a ``TrainState``) on
        ``device`` (``None``: CUDA). Skips back past corrupt checkpoints
        and past those whose keys or shapes differ from ``like``'s (a
        different model). Returns (step, state) or (None, None) if nothing
        valid exists. The restored tensors take ``like``'s dtypes.

        ``placements`` (``{parameter name: DTensor placements}``, as
        ``models.model.model_placements`` gives): each parameter and its
        moments become DTensors of those placements on the installed
        mesh, each rank keeping its own shards (every rank reads the
        files)."""
        dev = resolve_device(device)
        like_leaves = _leaves(like)
        candidates = self.all_steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for cand in reversed(candidates):
            path = os.path.join(self.dir, f"step_{cand:010d}")
            manifest = self._verify(path)
            if manifest is None:
                continue  # corrupt/partial: skip back
            arrays = {}
            for key, info in manifest["arrays"].items():
                arrays[key] = np.load(os.path.join(path, info["file"]))
            if set(arrays) != {k for k, *_ in like_leaves} | {".step"}:
                continue  # structure mismatch (different model)
            if any(arrays[k].shape != ((len(ts),) if stacked else ())
                   + tuple(ts[0].shape)
                   for k, ts, stacked in like_leaves):
                continue
            return cand, self._rebuild(like, arrays, dev, placements)
        return None, None

    @staticmethod
    def _rebuild(like, arrays: dict, dev, placements=None) -> TrainState:
        """A new ``TrainState`` on ``dev`` from ``arrays`` (checked against
        ``like``'s keys and shapes), in ``like``'s dtypes, laid out by
        ``placements`` on the installed mesh when given."""
        from torch.distributed.tensor import distribute_tensor
        model = like.params
        slots = {name: (leaf.key, rep, leaf.stacked)
                 for leaf in reference_leaves(model.cfg)
                 for rep, name in enumerate(leaf.names)}

        def load(prefix, tensors):
            out = {}
            for name, (key, rep, stacked) in slots.items():
                arr = arrays[f"{prefix}/{key}"]
                t = torch.from_numpy(np.ascontiguousarray(
                    arr[rep] if stacked else arr)).to(
                        device=dev, dtype=tensors[name].dtype)
                if placements is not None:
                    t = distribute_tensor(t, get_mesh(), placements[name],
                                          src_data_rank=None)
                out[name] = t
            return out

        new_model = Model(model.cfg, device="meta",
                          param_dtype=model.param_dtype)
        new_model.load_state_dict(
            load(".params", dict(model.named_parameters())), assign=True)
        opt = {k: load(f".opt/{k}", like.opt[k]) for k in like.opt}
        return TrainState(params=new_model, opt=opt,
                          step=int(arrays[".step"]))
