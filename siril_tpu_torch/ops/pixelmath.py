"""Pixel math — counterpart of ``siril_tpu/ops/pixelmath.py`` (the ``pm
"expression"`` command): the safe ``ast`` evaluator (``evaluate``:68) over
torch tensors on the images' device, and ``pixel_math`` (:125).

Supported, as in the JAX package: variables (loaded image names / $T),
literals, + - * / ^ %, comparisons, iif(cond,a,b), the functions of
``_fns`` (:29-58) and the constants e and pi.  A function given Python
numbers computes on a float32 0-d tensor, as ``jnp`` does on weakly typed
scalars.  The statistics take the whole image: ``median``, ``mad``,
``mdev`` and ``noise`` through the mean-of-middle median of
``jnp.median``, ``sdev`` with ddof 0 as ``jnp.std``.
"""

from __future__ import annotations

import ast
import math
import operator
from typing import Dict, Optional

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.wavelets import median_all


class PixelMathError(ValueError):
    pass


def _fns(device):
    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.tensor(
            v, dtype=torch.float32, device=device)

    def f1(fn):
        return lambda x: fn(t(x))

    def f2(fn):
        return lambda a, b: fn(t(a), t(b))

    def mtf_fn(m, x):
        num = (m - 1.0) * x
        den = (2.0 * m - 1.0) * x - m
        return num / torch.where(t(den) == 0, 1e-30, den)

    def mad(x):
        x = t(x)
        return median_all(torch.abs(x - median_all(x)))

    return {
        "abs": f1(torch.abs), "acos": f1(torch.acos), "asin": f1(torch.asin),
        "atan": f1(torch.atan), "atan2": f2(torch.atan2),
        "ceil": f1(torch.ceil), "cos": f1(torch.cos), "cosh": f1(torch.cosh),
        "exp": f1(torch.exp), "floor": f1(torch.floor), "ln": f1(torch.log),
        "log": f1(torch.log10), "log10": f1(torch.log10),
        "log2": f1(torch.log2), "max": f2(torch.maximum),
        "min": f2(torch.minimum), "pow": f2(torch.pow),
        "sin": f1(torch.sin), "sinh": f1(torch.sinh), "sqrt": f1(torch.sqrt),
        "tan": f1(torch.tan), "tanh": f1(torch.tanh),
        "truncate": f1(torch.trunc), "trunc": f1(torch.trunc),
        "iif": lambda c, a, b: torch.where(t(c) != 0, t(a), t(b)),
        "mtf": mtf_fn,
        "asinh": f1(torch.asinh),
        "mean": lambda *a: sum(a) / len(a),
        # statistical reductions over an image argument
        # (pixel_math_runner.c stat functions)
        "median": lambda x: median_all(t(x)),
        "mad": mad,
        "mdev": mad,
        "adev": lambda x: torch.mean(torch.abs(t(x) - torch.mean(t(x)))),
        "sdev": lambda x: torch.std(t(x), correction=0),
        "avg": lambda x: torch.mean(t(x)),
        "noise": lambda x: 1.4826 * mad(x),
    }


_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.Div: operator.truediv,
           ast.Pow: operator.pow, ast.Mod: operator.mod}
_CMPOPS = {ast.Gt: operator.gt, ast.Lt: operator.lt, ast.GtE: operator.ge,
           ast.LtE: operator.le, ast.Eq: operator.eq, ast.NotEq: operator.ne}


def evaluate(expr: str, variables: Dict[str, object],
             device: DeviceLike = None):
    """Evaluate a pixel-math expression with image variables (tensors on
    one device; ``device`` holds the scalars when there are none)."""
    dev = next((v.device for v in variables.values()
                if isinstance(v, torch.Tensor)), None) or \
        resolve_device(device)
    expr = expr.strip().replace("^", "**")
    fns = _fns(dev)
    consts = {"pi": math.pi, "e": math.e}

    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise PixelMathError(f"syntax error in expression: {e}") from None

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)):
                return float(node.value)
            raise PixelMathError(f"bad literal {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id in variables:
                return variables[node.id]
            if node.id in consts:
                return consts[node.id]
            raise PixelMathError(f"unknown variable '{node.id}'")
        if isinstance(node, ast.BinOp):
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise PixelMathError("unsupported operator")
            return op(ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return v
            raise PixelMathError("unsupported unary operator")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise PixelMathError("chained comparisons unsupported")
            op = _CMPOPS.get(type(node.ops[0]))
            if op is None:
                raise PixelMathError("unsupported comparison")
            return op(ev(node.left), ev(node.comparators[0]))
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name):
                raise PixelMathError("bad function call")
            fn = fns.get(node.func.id)
            if fn is None:
                raise PixelMathError(f"unknown function '{node.func.id}'")
            return fn(*[ev(a) for a in node.args])
        raise PixelMathError(f"unsupported syntax: {type(node).__name__}")

    return ev(tree)


def pixel_math(expr: str, images: Dict[str, SirilImage],
               rescale: bool = False, rescale_range: Optional[tuple] = None,
               device: DeviceLike = None) -> SirilImage:
    """`pm` command: evaluate expression over loaded images."""
    if not images:
        raise PixelMathError("pixel math needs at least one image")
    dev = resolve_device(device)
    first = next(iter(images.values()))
    variables = {name: torch.from_numpy(im.host()).to(dev)
                 for name, im in images.items()}
    shapes = {tuple(v.shape) for v in variables.values()}
    if len(shapes) > 1:
        raise PixelMathError(f"image dimensions differ: {shapes}")
    out = evaluate(expr, variables, dev)
    out = torch.as_tensor(out, device=dev).to(torch.float32).broadcast_to(
        first.data.shape)
    if rescale:
        lo, hi = rescale_range or (0.0, 1.0)
        mn = out.min()
        mx = out.max()
        out = torch.where(mx > mn, (out - mn) / (mx - mn) * (hi - lo) + lo,
                          out)
    out = torch.clamp(out, 0.0, 1.0)
    res = first.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history(f"Pixel math: {expr}")
    return res
