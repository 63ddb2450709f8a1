"""Image arithmetic — counterpart of ``siril_tpu/ops/arithmetic.py``
(``src/core/arithm.c``: imoper / soper / siril_fdiv / addmax) on torch
tensors, in float32 on their device.

- ``imoper``: ADD / SUB unclamped, MUL plain, DIV with b == 0 → 0
  (arithm.c:355-367), an optional factor;
- ``clip16=True`` emulates the reference's DATA_USHORT path: the result
  is rounded to u16 (half to even, as numpy and torch round) and
  truncated to [0, 65535], in the [0, 1] float scale (``_q16``).
"""

from __future__ import annotations

import numpy as np
import torch

OPER_ADD = 0
OPER_SUB = 1
OPER_MUL = 2
OPER_DIV = 3

_U16 = float(np.float32(65535.0))


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded once, as numpy divides: on the card a Python scalar
    divisor becomes a multiplication by its reciprocal, a 0-d tensor on
    the card does not."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _q16(v: torch.Tensor) -> torch.Tensor:
    """roundf-to-WORD semantics in [0,1] float scale."""
    return _div(torch.clamp(torch.round(v * _U16), 0.0, 65535.0), _U16)


def imoper(a: torch.Tensor, b: torch.Tensor, oper: int, factor: float = 1.0,
           clip16: bool = False) -> torch.Tensor:
    """a OP b elementwise; returns a new tensor."""
    a = a.float()
    b = b.float()
    if oper == OPER_ADD:
        r = a + b
    elif oper == OPER_SUB:
        r = a - b
    elif oper == OPER_MUL:
        r = a * b
    elif oper == OPER_DIV:
        r = torch.where(b == 0.0, 0.0, a / torch.where(b == 0.0, 1.0, b))
    else:
        raise ValueError(f"bad operator {oper}")
    if factor != 1.0:
        r = r * float(np.float32(factor))
    if clip16:
        r = _q16(r)
    return r


def soper(a: torch.Tensor, scalar: float, oper: int,
          clip16: bool = False) -> torch.Tensor:
    """a OP scalar (soper, arithm.c:184); DIV by zero rejected."""
    a = a.float()
    s = float(np.float32(scalar))
    if oper == OPER_ADD:
        r = a + s
    elif oper == OPER_SUB:
        r = a - s
    elif oper == OPER_MUL:
        r = a * s
    elif oper == OPER_DIV:
        if scalar == 0.0:
            raise ZeroDivisionError("cannot divide by zero")
        r = _div(a, s)
    else:
        raise ValueError(f"bad operator {oper}")
    if clip16:
        r = _q16(r)
    return r


def fdiv(a: torch.Tensor, b: torch.Tensor, coef: float,
         clip16: bool = False) -> torch.Tensor:
    """a = coef * a / b (siril_fdiv, arithm.c:540) — flat-field division."""
    return imoper(a, b, OPER_DIV, factor=coef, clip16=clip16)


def addmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a = max(a, b) (arithm.c:545)."""
    return torch.maximum(a.float(), b.float())
