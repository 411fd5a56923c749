"""Operator lifecycle: a port of qnnpack_tpu/ops/base.py.

QNNPACK's create -> setup -> run -> delete lifecycle
(include/qnnpack.h:40-332) maps onto:

  create -> validate params (the same self-explaining rejection messages
            and exception types as the JAX package), precompute
            quantization params and tables, and put them on `device`
            (the GPU unless the caller asks for the CPU)
  setup    nothing to bind: PyTorch runs eagerly, so any shape runs
  run    -> `op(*inputs)` on tensors on the operator's device
  delete -> `op.delete()` releases the operator's device tensors; a deleted
            operator raises UninitializedError when run

Not carried over: `Operator.lower` and `jit_forward`, which expose the
JAX package's jit tracing and have no PyTorch counterpart.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..status import (InvalidParameterError, UninitializedError,
                      UnsupportedParameterError)


def check(cond: bool, message: str):
    """Validation with reference-style diagnostics (every rejected parameter
    explains itself; cf. convolution.c:76-168)."""
    if not cond:
        raise InvalidParameterError(message)


def check_supported(cond: bool, message: str):
    if not cond:
        raise UnsupportedParameterError(message)


def check_scale(scale: float, name: str):
    check(scale > 0.0 and math.isfinite(scale),
          f"failed to create operator with {scale:.7g} {name} scale: "
          f"scale must be finite and positive")


def check_range(output_min: int, output_max: int):
    check(0 <= output_min <= 255 and 0 <= output_max <= 255
          and output_min <= output_max,
          f"failed to create operator with [{output_min}, {output_max}] "
          f"output range: range min must be below range max within [0, 255]")


def check_zero_point(zp: int, name: str):
    check(0 <= zp <= 255,
          f"failed to create operator with {zp} {name} zero point: "
          f"zero point must be in [0, 255]")


class Operator:
    """Base operator.  A subclass validates its parameters, then calls
    `super().__init__(device)`, builds its tables on `self.device` and
    implements `_forward`; `_tensors` names the attributes that `delete`
    releases."""

    name = "operator"
    _tensors: tuple = ()

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._deleted = False

    def _forward(self, *inputs):
        raise NotImplementedError

    def __call__(self, *inputs):
        if self._deleted:
            raise UninitializedError(
                f"failed to run {self.name} operator: it has been deleted")
        for x in inputs:
            if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
                raise TypeError(f"{self.name} operator takes uint8 tensors, "
                                f"got {type(x).__name__}")
            if x.device.type != self.device.type:
                raise ValueError(f"{self.name} operator lives on "
                                 f"{self.device}, input on {x.device}")
        return self._forward(*inputs)

    def delete(self):
        """Parity with qnnp_delete_operator (operator-delete.c): releases
        the operator's device tensors."""
        for attr in self._tensors:
            setattr(self, attr, None)
        self._deleted = True
