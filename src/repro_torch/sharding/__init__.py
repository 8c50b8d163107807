from repro_torch.sharding.rules import (
    Sharding,
    batch_axes,
    batch_shardings,
    decode_state_shardings,
    distribute,
    fsdp_axes,
    local_shape,
    param_shardings,
    param_spec,
    placements,
    state_shardings,
)

__all__ = [
    "Sharding",
    "batch_axes",
    "batch_shardings",
    "decode_state_shardings",
    "distribute",
    "fsdp_axes",
    "local_shape",
    "param_shardings",
    "param_spec",
    "placements",
    "state_shardings",
]
