"""The session commands — counterpart of ``siril_tpu/cli/commands2.py``
(``help``:34, ``clear``:46, ``log``:52, ``reloadscripts``:148,
``precompile``:924) and ``siril_tpu/cli/commands.py`` (``pwd``:226,
``ls`` / ``dir``:231, ``set``:259, ``get``:275, ``setmem``:287,
``setcpu``:292, ``capabilities``:297, ``exit``:335, ``undo``:3013,
``redo``:3023, ``pyscript``:3054).

They log and return as the JAX package's do, except ``capabilities``,
which reports the port's own runtime, and ``precompile``: the JAX
command fills XLA's compile cache; here it builds the native libraries
of the session's device into ``_build/`` (``kernels/build.py``), so that
the next stack starts with them.  ``setmem`` acts on the memory budgets
of ``utils/devmem.py`` through the session's preferences, which are the
active ones; ``setcpu`` only stores the value, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

from siril_tpu_torch.cli.commands import COMMANDS, VERSION, _f, command
from siril_tpu_torch.cli.commands import parse_flags
from siril_tpu_torch.cli.context import CommandError, Session

_log = logging.getLogger(__name__)


@command("help", "help [command]")
def cmd_help(ctx: Session, args: List[str]) -> None:
    if args:
        c = COMMANDS.get(args[0].lower())
        if c is None:
            raise CommandError(f"unknown command: {args[0]}")
        _log.info("Usage: %s", c.usage or c.name)
    else:
        # the JAX package registers every name in lower case
        names = sorted({c.name.lower() for c in COMMANDS.values()})
        _log.info("%d commands: %s", len(names), " ".join(names))


@command("clear", "clear")
def cmd_clear(ctx: Session, args: List[str]) -> None:
    """Clears the GUI console in the reference: nothing to do headless."""


@command("log", "log text")
def cmd_log(ctx: Session, args: List[str]) -> None:
    _log.info("%s", " ".join(args))


@command("pwd", "pwd")
def cmd_pwd(ctx: Session, args: List[str]) -> None:
    _log.info("%s", ctx.cwd)


@command("ls", "ls", aliases=("dir",))
def cmd_ls(ctx: Session, args: List[str]) -> None:
    for f in sorted(os.listdir(ctx.cwd)):
        _log.info("%s", f)


@command("set", "set key=value | set -import=file", min_args=1)
def cmd_set(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.core.settings import Preferences

    a = args[0]
    if a.startswith("-import="):
        # the imported preferences become the session's, and active
        ctx.prefs = Preferences.load_ini(ctx.path(a.split("=", 1)[1]))
        return
    if "=" not in a:
        raise CommandError("usage: set key=value")
    k, v = a.split("=", 1)
    try:
        ctx.prefs.set(k, v)
    except KeyError as e:
        raise CommandError(str(e))


@command("get", "get key | get -a", min_args=1)
def cmd_get(ctx: Session, args: List[str]) -> None:
    if args[0] in ("-a", "-A"):
        for k, v in ctx.prefs.list_all().items():
            _log.info("%s = %s", k, v)
        return
    try:
        _log.info("%s = %s", args[0], ctx.prefs.get(args[0]))
    except KeyError as e:
        raise CommandError(str(e))


@command("setmem", "setmem ratio", min_args=1)
def cmd_setmem(ctx: Session, args: List[str]) -> None:
    ctx.prefs.memory_ratio = float(args[0])


@command("setcpu", "setcpu number", min_args=1)
def cmd_setcpu(ctx: Session, args: List[str]) -> None:
    ctx.prefs.cpu_threads = int(args[0])


def _k1_library() -> str:
    """The K1 library's state: built (its path) or not yet."""
    from siril_tpu_torch.kernels import build

    path = build._library_path("reject_stack")
    return f"built ({path})" if os.path.exists(path) else \
        "not built (built at the first stack on a card, or by precompile)"


@command("capabilities", "capabilities")
def cmd_capabilities(ctx: Session, args: List[str]) -> None:
    import torch

    _log.info("siril_tpu_torch %s (Siril-compatible command surface)",
              VERSION)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cards = ", ".join(torch.cuda.get_device_name(i) for i in range(n))
    _log.info("torch %s, CUDA %s: %d device(s)%s", torch.__version__,
              torch.version.cuda, n, f" ({cards})" if n else "")
    _log.info("Session device: %s", ctx.device or "cuda")
    _log.info("K1 kernel library: %s", _k1_library())
    _log.info("Formats: FITS (r/w, RICE/GZIP tile compression), SER (r/w), "
              "FITSEQ (r/w), XISF (r/w), AVI (r/w), PIC (r), DNG and camera "
              "raw (r), TIFF/PNG/BMP/PNM (r/w); JPEG/WebP/AVIF via PIL")
    try:
        import cv2  # noqa: F401

        _log.info("Film: import AVI/MPG/MPEG/MOV/MP4/WebM (ffmpeg); "
                  "export MP4/WebM (seqexport)")
    except ImportError:
        _log.info("Film: AVI only (OpenCV-ffmpeg unavailable)")
    _log.info("Commands: %d", len({c.name for c in COMMANDS.values()}))


@command("exit", "exit")
def cmd_exit(ctx: Session, args: List[str]) -> None:
    ctx.stop_requested = True


def _require_loaded(ctx: Session, name: str) -> None:
    if ctx.image is None:
        raise CommandError(f"Command {name} requires a loaded image")


@command("undo", "undo")
def cmd_undo(ctx: Session, args: List[str]) -> None:
    _require_loaded(ctx, "undo")
    us = ctx.undo_stack
    if us is None or not us.can_undo:
        raise CommandError("nothing to undo")
    img = us.undo(ctx.image)
    if img is not None:
        ctx.image = img


@command("redo", "redo")
def cmd_redo(ctx: Session, args: List[str]) -> None:
    _require_loaded(ctx, "redo")
    us = ctx.undo_stack
    if us is None or not us.can_redo:
        raise CommandError("nothing to redo")
    img = us.redo(ctx.image)
    if img is not None:
        ctx.image = img


@command("pyscript", "pyscript script.py [args…]", min_args=1)
def cmd_pyscript(ctx: Session, args: List[str]) -> None:
    """Run a Python script over the sirilpy wire protocol: a socket server
    is started ($MY_SOCKET) and the script runs in a subprocess of the
    current interpreter, with a ``siril`` wire client
    (``pythonmodule/server.run_python_script``)."""
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.pythonmodule.server import run_python_script

    resolve_device(ctx.device)
    path = ctx.path(args[0])
    if not os.path.exists(path):
        raise CommandError(f"script not found: {args[0]}")
    rc = run_python_script(path, ctx, args=list(args[1:]))
    if rc != 0:
        raise CommandError(f"python script failed (exit code {rc})")


@command("reloadscripts", "reloadscripts")
def cmd_reloadscripts(ctx: Session, args: List[str]) -> None:
    """Sync and list the script repository (io/siril_git.c
    auto_update_gitscripts): nothing but the log line unless
    ``use_scripts_repository`` is set."""
    from siril_tpu_torch.utils.scriptrepo import (
        SCRIPT_REPOSITORY_URL,
        list_scripts,
        repo_path,
        sync_repository,
    )

    if not getattr(ctx.prefs, "use_scripts_repository", False):
        _log.info("scripts reloaded")
        return
    url = os.environ.get("SIRIL_TPU_SCRIPT_REPO", SCRIPT_REPOSITORY_URL)
    path = os.environ.get("SIRIL_TPU_SCRIPT_REPO_DIR", repo_path())
    if sync_repository(url, path):
        scripts = list_scripts(path)
        _log.info("scripts reloaded: %d repository scripts available",
                  len(scripts))
    else:
        _log.info("scripts reloaded (repository sync failed)")


@command("precompile",
         "precompile nb_frames [-width=] [-height=] [-channels=] "
         "[-rej=type[,type...]] [-sig=lo,hi] [-pipeline] "
         "[-persp[=D,D...]]",
         min_args=1)
def cmd_precompile(ctx: Session, args: List[str]) -> None:
    """Build the native kernel libraries of the session's device into
    ``_build/`` so that the next stack starts with them (the JAX command
    fills XLA's compile cache for the same shapes).  The arguments are
    read and checked as there; one library serves every shape, rejection
    and frame count.  A CPU session runs the plain versions and builds
    nothing; a card session without nvcc raises."""
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.ops import rejection as rj

    pos, flags = parse_flags(args)
    n = int(pos[0])
    width = int(_f(flags.get("width"), 4096))
    height = int(_f(flags.get("height"), 4096))
    channels = int(_f(flags.get("channels"), 1))
    siglow, sighigh = 3.0, 3.0
    if isinstance(flags.get("sig"), str):
        siglow, sighigh = (float(v) for v in flags["sig"].split(","))
    rejs = ["winsorized"]
    if isinstance(flags.get("rej"), str):
        rejs = [r.strip().lower() for r in flags["rej"].split(",")]
        unknown = [r for r in rejs if r not in rj.REJECTION_NAMES]
        if unknown:
            raise CommandError(f"unknown rejection type {unknown[0]!r}")
    if isinstance(flags.get("persp"), str):
        try:
            dbuckets = tuple(int(v) for v in flags["persp"].split(","))
        except ValueError:
            raise CommandError("-persp= expects D values from 2,4,8,16")
        if not dbuckets or not set(dbuckets) <= {2, 4, 8, 16}:
            raise CommandError("-persp= expects D values from 2,4,8,16")
    dev = resolve_device(ctx.device)
    shape = (f"{n} x {channels} x {height} x {width}, {', '.join(rejs)} "
             f"{siglow:g}/{sighigh:g}")
    if dev.type != "cuda":
        _log.info("precompile: the CPU uses no kernel (the plain PyTorch "
                  "versions run there); nothing to build for %s", shape)
        return
    from siril_tpu_torch.kernels import build

    build._nvcc()                   # raises without the CUDA toolkit
    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(build.CSRC)
                   if f.endswith(".cu"))
    before = {nm: os.path.exists(build._library_path(nm)) for nm in names}
    paths = build.build(names)
    for nm in names:
        _log.info("precompile: %s %s (%s)", nm,
                  "already built" if before[nm] else "built", paths[nm])
    _log.info("precompile: %d libraries for %s in %.1fs", len(names), shape,
              time.perf_counter() - t0)
