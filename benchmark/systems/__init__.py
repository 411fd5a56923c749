"""The program under test set up on the benchmark's raw weights: one module
a configuration, each with `build(cfg, weights, device)`."""

from __future__ import annotations

PORT_CONSTANTS = {"act_scale": "ACT_SCALE", "act_zero_point": "ACT_ZP",
                  "kernel_scale": "KERNEL_SCALE",
                  "kernel_zero_point": "KERNEL_ZP"}


def require_port_quantization(cfg: dict, module, fixed: dict = ()) -> None:
    """Raise unless the configuration's scales and zero points are those the
    port's model `module` builds its spec with.  The port's builders take
    widths and no scale, so a scale edited in the configuration would reach
    the reference alone; `fixed` adds values the port writes in its code."""
    q = cfg["quantization"]
    want = {key: getattr(module, name) for key, name in
            PORT_CONSTANTS.items()}
    want.update(fixed)
    for key, port in want.items():
        if q[key] != port:
            raise ValueError(
                f"{cfg['name']}: quantization.{key} is {q[key]}, the port's "
                f"{module.__name__} builds with {port}; its builder takes "
                "no scale, so the configuration has to match it")
