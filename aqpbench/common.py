"""What every run loop shares: the seed streams, the end of set-up, the
port's framework as a configuration states it, and the device record of a
traced window."""
from __future__ import annotations

import gc

import numpy as np

from aqpbench import trace as tr


class Seeds:
    """Independent streams drawn from one ``--seed`` (any whole number)."""

    def __init__(self, seed: int):
        self.seed = abs(int(seed))

    def __call__(self, *stream: int) -> int:
        ss = np.random.SeedSequence([self.seed, *stream])
        return int(ss.generate_state(1, np.uint32)[0])

    @property
    def data(self) -> int:
        return self(0)

    def sample(self, k: int) -> int:
        return self(1, k)

    @property
    def check(self) -> int:
        return self(4)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def settle(dev) -> None:
    """The end of set-up: the device idle, and what set-up made moved out
    of the collector's reach, so no full collection walks it in the
    window."""
    sync(dev)
    gc.collect()
    gc.freeze()


def framework(config: dict, seed: int, dev):
    """The port's ``AQPFramework`` with the configuration's build
    parameters and sample seed ``seed``, GreedyGD on."""
    from repro_torch.aqp.engine import AQPFramework
    from repro_torch.core.types import BuildParams
    params = BuildParams(seed=seed, **config["build"])
    return AQPFramework(params, use_compression=True, device=dev)


def device_record(record: dict, dtrace, recorder, t0: float, t1: float,
                  spans) -> None:
    """A traced window's busy and window seconds, roofline shares and
    breakdown (device operations; idle seconds by host span)."""
    ev = dtrace.events
    record["window_s"] = t1 - t0
    record["busy_s"] = tr.busy_s(ev, t0, t1)
    record["rooflines"] = tr.rooflines(ev, recorder)
    record["breakdown"] = {
        "device_ops": [[n, s] for n, s in tr.top_ops(ev, t0, t1)],
        "idle_gaps": [[n, s] for n, s in tr.labelled_gaps(
            tr.idle_gaps(ev, t0, t1), spans)]}
