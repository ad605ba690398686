"""The FLOPs of the dots in an XLA HLO module's text (``compiled.as_text()``),
each counted once for every run of the computation that holds it.

A computation runs once for each run of the instruction that calls it: a
``fusion`` or ``call`` (``calls=``, ``to_apply=``), a conditional's branch.
A ``while`` runs its body ``known_trip_count`` times, the count XLA states
in the instruction's backend config, and its condition once more; a loop
without a known count raises. A ``jax.lax.scan`` lowers to such a loop, so
counting each dot of the text once would count its body once instead of
once a trip.

The tests import this module beside them; the reference's compiles, in
subprocesses, import it with the tests directory on their path.
"""
from __future__ import annotations

import functools
import math
import re

_HEADER = re.compile(r"(ENTRY )?%([\w.\-]+) .*\{$")
_SHAPE = re.compile(r"%([\w.\-]+) = \w+\[([0-9,]*)\]")
_DOT = re.compile(r"= \w+\[([0-9,]*)\]\S* dot\(%([\w.\-]+), %[\w.\-]+\)"
                  r".*?lhs_contracting_dims=\{([0-9,]*)\}")
_CALLEE = re.compile(r"\b(?:calls|to_apply|true_computation|"
                     r"false_computation)=%([\w.\-]+)")
_BRANCHES = re.compile(r"\bbranch_computations=\{([^}]*)\}")
_TRIPS = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_WHILE = re.compile(r" while\(.*?\bcondition=%([\w.\-]+), "
                    r"body=%([\w.\-]+)")


def _dims(text: str) -> list:
    return [int(v) for v in text.split(",") if v]


def computations(hlo: str) -> tuple:
    """``({name: [instruction lines]}, the entry computation's name)``."""
    comps, entry, name = {}, None, None
    for line in hlo.splitlines():
        if name is None:
            m = _HEADER.match(line)
            if m:
                name = m.group(2)
                comps[name] = []
                entry = name if m.group(1) else entry
        elif line == "}":
            name = None
        else:
            comps[name].append(line)
    if entry is None:
        raise ValueError("no ENTRY computation in the HLO text")
    return comps, entry


def _callees(line: str) -> list:
    """``[(computation, runs a run of the line)]`` that ``line`` calls."""
    loop = _WHILE.search(line)
    if loop:
        trips = _TRIPS.search(line)
        if trips is None:
            raise ValueError(f"a while loop with no known trip count: "
                             f"{line[:200]}")
        n = int(trips.group(1))
        return [(loop.group(1), n + 1), (loop.group(2), n)]
    called = [(c, 1) for c in _CALLEE.findall(line)]
    for branches in _BRANCHES.findall(line):
        called += [(c.strip().lstrip("%"), 1) for c in branches.split(",")
                   if c.strip()]
    return called


def dots(hlo: str) -> tuple:
    """``(FLOPs of every dot, FLOPs of the dots whose left operand is
    2-D)``, each dot's 2 x output x contracted size times the runs of its
    computation in one run of the entry computation."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _SHAPE.finditer(hlo)}
    comps, entry = computations(hlo)

    @functools.lru_cache(maxsize=None)
    def flops(name: str) -> tuple:
        total = two_d = 0
        for line in comps[name]:
            m = _DOT.search(line)
            if m:
                lhs = shapes[m.group(2)]
                k = math.prod(lhs[i] for i in _dims(m.group(3)))
                n = 2 * math.prod(_dims(m.group(1))) * k
                total += n
                two_d += n if len(lhs) == 2 else 0
            for callee, runs in _callees(line):
                sub_total, sub_two_d = flops(callee)
                total += runs * sub_total
                two_d += runs * sub_two_d
        return total, two_d

    return flops(entry)
