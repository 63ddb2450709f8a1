"""The planetary session's commands — counterpart of
``siril_tpu/cli/commands.py`` (``_mpp_args_from_flags``:2568, ``mpp``
:2609, ``register_mpp``:2628, ``stack_mpp``:2641, ``seqquality``:2665).

Every stage runs on ``Session.device``: the frame quality, the phase
correlation, MultiLevelCorrelation and the AP stack (``planetary/``).  As
in the JAX package, ``stack_mpp`` takes the AP size from the ``.mpp``
sidecar and every other argument from its own flags, so ``-layer`` is not
carried over from ``register_mpp`` (ROADMAP §3).  Each command leaves
the seconds of its stages in ``Session.stages`` (quality, global,
reference, shifts, sidecar, stack, assembly).
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np

from siril_tpu_torch.cli.commands import command, parse_flags
from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.core.image import FLOAT_IMG

_log = logging.getLogger(__name__)


def _mpp_args_from_flags(flags: dict):
    """The MPP flags (command_list.h:140,168): -half-box / -ap-step map to
    the AP size and overlap, the percent flags to the best-N selections."""
    from siril_tpu_torch.planetary.mpp import MPPArgs

    a = MPPArgs()
    if "apsize" in flags:
        a.ap_size = int(float(flags["apsize"]))
    if "half-box" in flags:
        a.ap_size = 2 * int(float(flags["half-box"]))
    if "overlap" in flags:
        a.ap_overlap = float(flags["overlap"])
    if "ap-step" in flags:
        step = int(float(flags["ap-step"]))
        a.ap_overlap = max(0.0, 1.0 - step / max(a.ap_size, 1))
    if "bestpct" in flags:
        a.stack_best_pct = float(flags["bestpct"])
    if "stack-percent" in flags:
        a.stack_best_pct = float(flags["stack-percent"])
    if "register-percent" in flags:
        a.stack_best_pct = float(flags["register-percent"])
    if "refpct" in flags:
        a.global_best_pct = float(flags["refpct"])
    if "ref-percent" in flags:
        a.global_best_pct = float(flags["ref-percent"])
    if "stack-frames" in flags:
        a.max_frames = int(float(flags["stack-frames"]))
    if "min-structure" in flags:
        a.structure_threshold = float(flags["min-structure"])
    if "scale" in flags:
        a.scale = float(flags["scale"])
    if "layer" in flags:
        a.layer = int(float(flags["layer"]))
    return a


def _sidecar(seq) -> str:
    return os.path.join(seq.directory, seq.name + ".mpp")


def _write_result(ctx: Session, seq, flags: dict, out) -> None:
    from siril_tpu_torch.io.fits_io import write_fits

    name = flags.get("out") if isinstance(flags.get("out"), str) else \
        seq.name + "_mpp"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(out, p, bitdepth=FLOAT_IMG)
    ctx.set_image(out, os.path.basename(p))


@command("mpp", "mpp sequencename [-apsize=] [-overlap=] [-bestpct=] "
         "[-scale=] [-out=]", min_args=1)
def cmd_mpp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.planetary.mpp import mpp_full

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    ctx.stages = {}
    out = mpp_full(seq, _mpp_args_from_flags(flags), sidecar=_sidecar(seq),
                   device=ctx.device, stages=ctx.stages)
    _write_result(ctx, seq, flags, out)


@command("register_mpp", "register_mpp sequencename [flags]", min_args=1)
def cmd_register_mpp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.planetary.mpp import (
        mpp_analyze,
        mpp_compute_shifts,
    )
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.ops.stacking import StageClock

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    a = _mpp_args_from_flags(flags)
    ctx.stages = {}
    state = mpp_analyze(seq, a, ctx.device, ctx.stages)
    state = mpp_compute_shifts(seq, state, a, ctx.device, ctx.stages)
    with StageClock(resolve_device(ctx.device), "mpp.",
                    ctx.stages)("sidecar"):
        state.save(_sidecar(seq))
    _log.info("MPP registration saved to %s.mpp", seq.name)


@command("stack_mpp", "stack_mpp sequencename [-bestpct=] [-out=]",
         min_args=1)
def cmd_stack_mpp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.planetary.mpp import MPPState, mpp_stack

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    sc = _sidecar(seq)
    if not os.path.exists(sc):
        raise CommandError(f"no .mpp sidecar for {seq.name} "
                           "(run register_mpp first)")
    state = MPPState.load(sc)
    a = _mpp_args_from_flags(flags)
    a.ap_size = state.args.ap_size if state.args else a.ap_size
    ctx.stages = {}
    _write_result(ctx, seq, flags,
                  mpp_stack(seq, state, a, ctx.device, ctx.stages))


@command("seqquality", "seqquality sequencename [layer]", min_args=1)
def cmd_seqquality(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.planetary.quality import rank_sequence_quality

    seq = ctx.load_sequence(args[0])
    layer = int(float(args[1])) if len(args) > 1 else 0
    rank_sequence_quality(seq, layer, device=ctx.device)
    seq.save()
    reg = seq.reg(layer)
    order = np.argsort(-reg.quality)[:5]
    _log.info("Best frames: " + ", ".join(
        f"{i + 1} ({reg.quality[i]:.3f})" for i in order))
