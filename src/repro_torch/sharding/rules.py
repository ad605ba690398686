"""Logical-axis sharding rules (MaxText-style) for the LM substrate.

The port of ``src/repro/sharding/rules.py`` onto ``torch.distributed``:
the mesh is a ``DeviceMesh`` with the reference's axis names, and a
logical spec becomes DTensor placements.

Physical mesh axes:
  * ``pod``   — cross-pod data parallelism (multi-pod mesh only)
  * ``data``  — in-pod data parallel + ZeRO/FSDP weight sharding
  * ``model`` — tensor parallel (heads / d_ff / vocab / experts) and the
                residual-stream d_model shard between layers

Logical axes used by the model code:

  batch      -> (pod, data)      activations' leading dim
  embed      -> model            residual-stream d_model (activation only)
  fsdp       -> data             weight dim sharded ZeRO-style
  tensor     -> model            weight head/ff/vocab/expert dims
  kv_heads   -> model            KV-cache head dim (if divisible)
  none       -> replicated

The mesh is installed for the process via ``set_mesh`` (the reference's
is per thread: JAX traces on one thread, but PyTorch's autograd engine
replays a rematerialised forward in the backward pass on its own device
threads, which must see the same mesh and rules); with no mesh installed
every constraint returns its input, so single-device runs are unchanged.
"""
from __future__ import annotations

import contextlib

MESH_AXES = ("pod", "data", "model")

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "embed": ("model",),
    "fsdp": ("data",),
    "tensor": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_seq": (),           # enabled instead of kv_heads when heads < mesh
    "expert": ("model",),
    "vocab": ("model",),
    # Residual-stream (B, S, D) sharding between blocks: D by default; the
    # seq_sp variant shards S instead.
    "resid_seq": (),
    "resid_embed": ("model",),
    "blk_in_embed": ("model",),   # zero_r variant: () = replicate in-block
    None: (),
}

_state = {"mesh": None, "rules": LOGICAL_RULES}


def set_mesh(mesh, rules: dict | None = None):
    """Install ``mesh`` (a ``DeviceMesh`` or ``None``) and ``rules``
    (default ``LOGICAL_RULES``) for the process."""
    _state.update(mesh=mesh,
                  rules=dict(LOGICAL_RULES if rules is None else rules))


def get_mesh():
    return _state["mesh"]


def _rules() -> dict:
    return _state["rules"]


def logical_to_spec(logical_axes, shape=None) -> tuple:
    """Tuple of logical axis names (or None) -> per tensor dim, the tuple
    of mesh axes that shard it (``()``: unsharded), filtered to the axes
    of the installed mesh.

    When ``shape`` is given, any dim not evenly divisible by its mesh-axis
    product is left unsharded (this is also how non-divisible head counts
    fall back to replication)."""
    mesh = get_mesh()
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    sizes = dict(zip(names, mesh.shape)) if mesh is not None else {}
    rules = _rules()
    spec = []
    for d, ax in enumerate(logical_axes):
        phys = tuple(a for a in rules.get(ax, ()) if a in sizes)
        if shape is not None and phys:
            n = 1
            for a in phys:
                n *= sizes[a]
            if shape[d] % n != 0:
                phys = ()
        spec.append(phys)
    return tuple(spec)


def placements(logical_axes, shape=None) -> tuple:
    """The DTensor placements of ``logical_to_spec``: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = get_mesh()
    spec = logical_to_spec(logical_axes, shape)
    out = [Replicate()] * mesh.ndim
    for d, phys in enumerate(spec):
        for a in phys:
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def constrain(x, *logical_axes):
    """``x`` redistributed to the placements of ``logical_axes`` when a
    mesh is installed and ``x`` is a DTensor; else ``x`` itself."""
    mesh = get_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(logical_axes, x.shape))


@contextlib.contextmanager
def replicate_plain():
    """While a mesh is installed, plain tensors that meet DTensors in an op
    (positions, masks, rope tables: the same on every rank) read as
    replicated DTensors (``implicit_replication``, which the autograd
    engine carries into the backward pass); without a mesh, nothing.
    Entered once, around a whole step: it does not nest."""
    if get_mesh() is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def param_sharding(logical_axes, shape=None):
    """The placements of a parameter with ``logical_axes``, or ``None``
    without a mesh."""
    if get_mesh() is None:
        return None
    return placements(logical_axes, shape)
