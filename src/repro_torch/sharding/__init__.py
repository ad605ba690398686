from repro_torch.sharding.rules import (  # noqa: F401
    LOGICAL_RULES,
    MESH_AXES,
    constrain,
    get_mesh,
    logical_to_spec,
    param_sharding,
    placements,
    replicate_plain,
    set_mesh,
)
