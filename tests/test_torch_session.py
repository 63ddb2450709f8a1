"""The port's session surface against the JAX package on the CPU: the
preferences (``core/settings``), the operation descriptors
(``core/opdesc``), undo and redo (``core/undo``), the session commands
(``cli/session.py``) and the CLI's ``-p``, ``-i`` and stdin modes.

Bounds: log lines, return codes, preferences, status lines and images
equal; ``capabilities`` and ``precompile`` report the port's own runtime
and are checked on their own.  The JAX package's CLI never activates the
preferences it reads (ROADMAP §3, departure 27): the test shows its
behaviour beside the port's.
"""

import ast
import configparser
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from siril_tpu.cli.context import Session as JSession
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io.fits_io import write_fits as jwrite
from siril_tpu_torch.cli.context import Session as TSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Both:
    """The two packages' sessions in their own directories; ``run`` sends
    one line through both parsers and returns (rc, log lines) of each."""

    def __init__(self, tmp_path, caplog, files=()):
        self.dirs = {}
        for who in ("jax", "port"):
            d = tmp_path / who
            d.mkdir()
            for name, data in files:
                jwrite(JImage(data=data), str(d / name), bitdepth=-32)
            self.dirs[who] = d
        self.j = JSession(cwd=str(self.dirs["jax"]))
        self.t = TSession(cwd=str(self.dirs["port"]), device="cpu")
        self.caplog = caplog

    def run(self, line):
        from siril_tpu.cli.parser import process_command_line as jrun
        from siril_tpu.utils.log import get_log_buffer
        from siril_tpu_torch.cli.parser import process_command_line as trun

        n0 = len(get_log_buffer())
        rj = jrun(self.j, line)
        jl = get_log_buffer()[n0:]
        self.caplog.clear()
        with self.caplog.at_level(logging.INFO, logger="siril_tpu_torch"):
            rt = trun(self.t, line)
        tl = [r.getMessage() for r in self.caplog.records
              if r.name.startswith("siril_tpu_torch.cli")]
        # each session's own directory reads as <cwd>
        jl = [ln.replace(str(self.dirs["jax"]), "<cwd>") for ln in jl]
        tl = [ln.replace(str(self.dirs["port"]), "<cwd>") for ln in tl]
        return (rj, jl), (rt, tl)

    def same(self, line):
        j, t = self.run(line)
        assert t == j, line
        return t


def _scene(seed=1, c=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (0.1 + 0.8 * rng.random((c, h, w))).astype(np.float32)


def test_undo_commands_from_jax_sources():
    """``core/undo.UNDO_COMMANDS`` is the set of the JAX package's
    commands whose ``set_image`` calls (followed through the helpers and
    the commands they call) pass no name."""
    from siril_tpu_torch.core.undo import UNDO_COMMANDS

    funcs, names_of = {}, {}
    for src in ("siril_tpu/cli/commands.py", "siril_tpu/cli/commands2.py"):
        tree = ast.parse(open(os.path.join(REPO, src)).read())
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            funcs[node.name] = node
            for d in node.decorator_list:
                if isinstance(d, ast.Call) and \
                        getattr(d.func, "id", "") == "command":
                    al = [kw.value for kw in d.keywords
                          if kw.arg == "aliases"]
                    names_of[node.name] = [d.args[0].value] + (
                        [e.value for e in al[0].elts] if al else [])

    def kinds(fn, seen):
        if fn in seen or fn not in funcs:
            return set()
        seen.add(fn)
        out = set()
        for n in ast.walk(funcs[fn]):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr == "set_image":
                out.add("named" if len(n.args) > 1 or n.keywords
                        else "undo")
            elif isinstance(f, ast.Name):
                out |= kinds(f.id, seen)
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Subscript) and \
                    isinstance(f.value.slice, ast.Constant):
                for fn2, names in names_of.items():
                    if f.value.slice.value in names:
                        out |= kinds(fn2, seen)
        return out

    undo = set()
    for fn, names in names_of.items():
        k = kinds(fn, set())
        assert k != {"undo", "named"}, fn
        if k == {"undo"}:
            undo |= {n.lower() for n in names}
    assert UNDO_COMMANDS == undo


UNDO_LINES = [
    "load a", "neg", "mirrorx", "undo", "redo", "undo", "undo", "undo",
    "crop 2 2 20 16", "mask_from_lum", "gauss 1", "clear_mask",
    "pm \"$a$ * 0.5\"", "load b", "fmul 1.5", "binxy 2", "rotatepi",
    "stack c_ sum -out=stacked", "undo", "redo", "load a", "asinh 2",
    "setmem 0.5", "satu 0.3", "undo", "close", "undo"]


def test_undo_parity_vs_jax(tmp_path, caplog):
    """One list of commands through both packages (loads, ops, a stack,
    crops, masks, pm, undo and redo): after each, the same return code,
    ``can_undo`` / ``can_redo``, history length and image."""
    files = [("a.fit", _scene(1)), ("b.fit", _scene(2, c=1))] + \
        [(f"c_{i + 1:05d}.fit", _scene(3 + i, c=1)) for i in range(3)]
    b = Both(tmp_path, caplog, files)
    for line in UNDO_LINES:
        (rj, _), (rt, _) = b.run(line)
        assert rt == rj, line
        ju, tu = b.j.undo_stack, b.t.undo_stack
        state = [(None if u is None else
                  (u.can_undo, u.can_redo, len(u.history())))
                 for u in (ju, tu)]
        assert state[1] == state[0], (line, state)
        if b.j.image is None:
            assert b.t.image is None, line
        else:
            np.testing.assert_allclose(b.t.image.host(), b.j.image.host(),
                                       atol=2e-6, err_msg=line)
    assert b.t.undo_stack.swap_dir != b.j.undo_stack.swap_dir


SESSION_LINES = [
    "help", "help setmem", "help load", "help no_such_command", "clear",
    "log a b  c",
    "pwd", "ls", "dir", "setcpu 3", "get cpu_threads", "set cpu_threads=5",
    "get cpu_threads", "get -a", "set memory_ratio=0.25",
    "get memory_ratio", "setmem 0.6", "get memory_ratio", "set foo",
    "set no_such_key=1", "get no_such_key", "setext fits",
    "get ext", "set16bits", "get force_16bit", "set32bits", "online",
    "get online", "offline", "undo", "redo", "reloadscripts",
    "set -import=prefs.ini", "get debayer_method", "get memory_ratio",
    "exit"]


def test_session_commands_vs_jax(tmp_path, caplog):
    """Each session command's log lines and return code, and the
    preferences after each, through both command tables."""
    from siril_tpu.core.settings import Preferences as JPrefs

    p = JPrefs()
    p.debayer_method = "vng"
    p.memory_ratio = 0.4
    b = Both(tmp_path, caplog)
    for d in b.dirs.values():
        p.save_ini(str(d / "prefs.ini"))
    for line in SESSION_LINES:
        b.same(line)
        assert b.t.prefs.list_all() == b.j.prefs.list_all(), line
    assert b.t.stop_requested and b.j.stop_requested
    assert b.t.prefs.debayer_method == "vng"


def test_capabilities_and_precompile(tmp_path, caplog, monkeypatch):
    """``capabilities`` reports the port's runtime; ``precompile`` checks
    its arguments as the JAX command does, builds nothing on a CPU
    session and raises on a card session without nvcc."""
    from siril_tpu.cli.parser import process_command_line as jrun
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.parser import process_command_line as trun

    s = TSession(cwd=str(tmp_path), device="cpu")
    caplog.set_level(logging.INFO, logger="siril_tpu_torch")
    assert trun(s, "capabilities") == 0
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "siril_tpu_torch 1.5.0" in text and "Session device: cpu" in text
    assert f"torch {torch.__version__}" in text and "Commands: " in text
    assert "K1 kernel library:" in text
    caplog.clear()
    assert trun(s, "precompile 8 -rej=w,s -sig=2,3") == 0
    assert "the CPU uses no kernel" in caplog.text
    # (the JAX command checks -persp= only after compiling the stack
    # kernels: the port's alone here)
    assert trun(s, "precompile 8 -persp=3") == 1
    assert jrun(JSession(cwd=str(tmp_path)), "precompile 8 -rej=nosuch") \
        == trun(s, "precompile 8 -rej=nosuch") == 1
    caplog.clear()
    assert trun(s, "precompile 8 -rej=nosuch") == 1
    assert "unknown rejection type 'nosuch'" in caplog.text
    # a card session without the toolkit
    from siril_tpu_torch.kernels import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    assert build  # imported before PATH changed
    with pytest.raises(RuntimeError, match="nvcc not found"):
        COMMANDS["precompile"].fn(TSession(cwd=str(tmp_path),
                                           device="cuda"), ["8"])


def test_preferences_ini_round_trip(tmp_path, monkeypatch):
    """The same ``[core]`` INI at the same path: each package reads what
    the other wrote, and their files are byte-equal."""
    from siril_tpu.core import settings as js
    from siril_tpu_torch.core import settings as ts

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert ts.default_ini_path() == js.default_ini_path() == \
        str(tmp_path / "siril_tpu" / "siril_tpu.ini")
    jp, tp = js.Preferences(), ts.Preferences()
    for p in (jp, tp):
        for k, v in (("debayer_method", "ahd"), ("memory_ratio", "0.3"),
                     ("mem_mode", "1"), ("force_16bit", "yes"),
                     ("sf-radius", "7"), ("ext", ".fts")):
            p.set(k, v)
    assert tp.list_all() == jp.list_all()
    a, b = str(tmp_path / "a.ini"), str(tmp_path / "b.ini")
    jp.save_ini(a)
    tp.save_ini(b)
    assert open(a).read() == open(b).read()
    assert ts.Preferences.load_ini(a).list_all() == jp.list_all()
    assert js.Preferences.load_ini(b).list_all() == tp.list_all()
    tp.save_ini()
    cp = configparser.ConfigParser()
    cp.read(js.default_ini_path())
    assert cp["core"]["debayer_method"] == "ahd"
    for p in (jp, tp):
        with pytest.raises(KeyError):
            p.get("no_such_key")


def test_departure_27_active_preferences(tmp_path, monkeypatch):
    """The JAX CLI reads the INI into ``ctx.prefs`` after activating
    another object, so neither the INI nor ``set`` reaches
    ``get_settings()``; in the port the session's preferences are the
    active ones, and the debayer method follows them."""
    from siril_tpu.cli.main import build_session as jbuild
    from siril_tpu.cli.parser import process_command_line as jrun
    from siril_tpu.core import settings as js
    from siril_tpu.utils import jaxcache
    from siril_tpu_torch.cli import build_session as tbuild
    from siril_tpu_torch.cli.parser import process_command_line as trun
    from siril_tpu_torch.core import settings as ts

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    monkeypatch.setattr(jaxcache, "enable_compilation_cache",
                        lambda *a, **k: "")
    p = js.Preferences()
    p.debayer_method = "vng"
    p.save_ini()
    j = jbuild(str(tmp_path))
    assert j.prefs.debayer_method == "vng"
    assert js.get_settings().debayer_method == "rcd"         # not active
    assert jrun(j, "set debayer_method=ahd") == 0
    assert js.get_settings().debayer_method == "rcd"
    t = tbuild(str(tmp_path), "cpu")
    assert ts.get_settings() is t.prefs
    assert ts.get_settings().debayer_method == "vng"
    assert trun(t, "set debayer_method=ahd") == 0
    assert ts.get_settings().debayer_method == "ahd"
    (tmp_path / "x.ini").write_text("[core]\ndebayer_method = bilinear\n")
    assert trun(t, "set -import=x.ini") == 0
    assert ts.get_settings() is t.prefs
    # the active method is the one the debayer takes
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops import demosaic

    cfa = SirilImage(data=_scene(4, c=1, h=16, w=16))
    cfa.keywords.bayer_pattern = "RGGB"
    got = demosaic.debayer_image(cfa, device="cpu").data
    want = demosaic.debayer(torch.from_numpy(cfa.data[0]), "RGGB",
                            demosaic.METHOD_NAMES["bilinear"]).numpy()
    np.testing.assert_array_equal(got, want)
    # the extension, 16-bit mode, compression and online are the same
    # state as the preferences
    assert trun(t, "setext fts") == 0 and t.prefs.ext == ".fts"
    assert trun(t, "set force_16bit=1") == 0 and t.force_16bit
    assert trun(t, "setcompress 1 -type=gzip2 8") == 0
    assert (t.prefs.comp_type, t.prefs.comp_quantization) == (2, 8.0)
    assert t.compression == "gzip2"
    assert trun(t, "set online=1") == 0 and t.online
    from siril_tpu_torch.astrometry.remote import UrllibTransport

    assert UrllibTransport().online
    assert trun(t, "offline") == 0 and not UrllibTransport().online


def test_setmem_scales_the_budgets(monkeypatch):
    """``setmem`` and ``mem_mode`` act on the fused, resident and
    compute budgets of ``utils/devmem`` as on the JAX package's
    ``memory_budget_bytes``."""
    from siril_tpu.core.settings import Preferences as JPrefs
    from siril_tpu.utils import devmem as jdm
    from siril_tpu_torch.cli.parser import process_command_line as trun
    from siril_tpu_torch.utils import devmem as tdm

    total = 80 << 30
    monkeypatch.setattr(tdm, "device_memory_bytes", lambda dev: total)
    card = torch.device("cpu")
    s = TSession(device="cpu")
    base = [tdm.fused_budget_bytes(card), tdm.resident_budget_bytes(card),
            tdm.memory_budget_bytes(card)]
    assert base == [int(total * 0.9), int(total * 0.9) // 3,
                    int(total * 0.9)]
    assert trun(s, "setmem 0.45") == 0
    half = [tdm.fused_budget_bytes(card), tdm.resident_budget_bytes(card),
            tdm.memory_budget_bytes(card)]
    assert half == [int(total * 0.45), int(total * 0.45) // 3,
                    int(total * 0.45)]
    monkeypatch.setattr(jdm, "device_hbm_bytes", lambda: total)
    for line in ("setmem 0.45", "setmem 3", "setmem 0.01",
                 "set mem_mode=1", "set memory_amount=12"):
        assert trun(s, line) == 0
        jp = JPrefs()
        for k, v in s.prefs.list_all().items():
            setattr(jp, k, v)
        assert tdm.memory_budget_bytes(card) == jdm.memory_budget_bytes(jp)
    assert tdm.fused_budget_bytes(card) == 12 << 30
    monkeypatch.setattr(tdm, "device_memory_bytes", lambda dev: None)
    assert tdm.fused_budget_bytes(card) == tdm.CPU_BUDGET_BYTES


def test_opdesc_tables_equal():
    from siril_tpu.core import opdesc as jo
    from siril_tpu_torch.core import opdesc as to

    def table(m):
        return {k: (d.id, d.name, d.mem_ratio, d.flags, d.mask_capable,
                    d.geometry_changing) for k, d in m.all_ops().items()}

    assert table(to) == table(jo) and len(table(to)) == 45
    for f in ("OP_MASK_CAPABLE", "OP_GEOMETRY_CHANGING", "OP_EXPENSIVE",
              "OP_REQ_RGB", "OP_REQ_MONO"):
        assert getattr(to, f) == getattr(jo, f)
    assert to.get("filters.gauss").mask_capable and to.get("nope") is None


PIPE_LINES = ["setext fits", "pwd", "load a", "mirrorx", "undo", "redo",
              "", "# a comment", "seqcrop c_ 0 0 8 8", "no_such_command",
              "get memory_ratio", "cancel", "exit", "pwd"]

_JAX_MAIN = (
    "import sys\n"
    "import siril_tpu.utils.jaxcache as c\n"
    "c.enable_compilation_cache = lambda *a, **k: ''\n"
    "from siril_tpu.cli.main import main\n"
    "sys.exit(main(sys.argv[1:]))\n")


def _cli(who, d, args, stdin, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XDG_CONFIG_HOME=str(tmp_path / "cfg"))
    if who == "jax":
        cmd = [sys.executable, "-c", _JAX_MAIN, "-d", str(d), *args]
    else:
        cmd = [sys.executable, "-m", "siril_tpu_torch.cli", "-d", str(d),
               "--device", "cpu", *args]
    out = subprocess.run(cmd, input=stdin, capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_pipe_and_stdin_modes_vs_jax(tmp_path):
    """``-p`` and commands piped on stdin, as subprocesses of both
    packages: the same ``status:`` lines, ``progress:`` lines for the
    sequence command, ``exit`` ending the loop; the same image saved."""
    files = [("a.fit", _scene(1))] + \
        [(f"c_{i + 1:05d}.fit", _scene(3 + i, c=1)) for i in range(3)]
    status, progress = {}, {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        for name, data in files:
            jwrite(JImage(data=data), str(d / name), bitdepth=-32)
        lines = _cli(who, d, ["-p"], "\n".join(PIPE_LINES) + "\n",
                     tmp_path)
        assert lines[0] == "ready:"
        status[who] = [ln for ln in lines if ln.startswith("status:")]
        progress[who] = [ln for ln in lines if ln.startswith("progress:")]
        assert any(ln.startswith("log: ") for ln in lines)
        _cli(who, d, [], "load a\nneg\nsave neg_a\nexit\nsave never\n",
             tmp_path)
        assert (d / "neg_a.fit").exists() and not (d / "never.fit").exists()
    assert status["port"] == status["jax"]
    assert status["port"][-1] == "status: success cancel"
    assert "status: error no_such_command" in status["port"]
    assert progress["port"] == progress["jax"] == [
        "progress: 0.33", "progress: 0.67", "progress: 1.00"]
    from siril_tpu_torch.io.fits_io import read_fits

    np.testing.assert_array_equal(
        read_fits(str(tmp_path / "port" / "neg_a.fit")).data,
        read_fits(str(tmp_path / "jax" / "neg_a.fit")).data)


class _Feed:
    """An input stream for the pipe: yields lines, waiting on an event
    before the ones marked so."""

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        for it in self.items:
            if isinstance(it, threading.Event):
                assert it.wait(60)
                continue
            yield it + "\n"


def test_pipe_loop_cancel_in_process(tmp_path, monkeypatch):
    """``pipe_loop`` on a session in process: ``cancel`` stops the
    running stack at once, its status follows in order, then the next
    command succeeds; each command's entry is in ``command_log``."""
    import io

    from siril_tpu_torch.cli import pipe_loop
    from siril_tpu_torch.core import processing
    from siril_tpu_torch.ops import stacking as st

    for i in range(4):
        jwrite(JImage(data=_scene(3 + i, c=1, h=64, w=48)),
               str(tmp_path / f"c_{i + 1:05d}.fit"), bitdepth=-32)
    started = threading.Event()
    inner = st.read_block

    def reading(*a, **k):
        started.set()
        t0 = time.monotonic()
        while processing.processing_should_continue() and \
                time.monotonic() - t0 < 30:
            time.sleep(0.01)
        return inner(*a, **k)

    monkeypatch.setattr(st, "read_block", reading)
    # row blocks of 8 rows (the stack polls between blocks); -rejmaps
    # takes the streamed path
    monkeypatch.setattr(st, "plan_blocks", lambda h, w, n, mb: 8)
    s = TSession(cwd=str(tmp_path), device="cpu")
    out = io.StringIO()
    pipe_loop(s, _Feed(["stack c_ rej 3 3 -norm=addscale -rejmaps",
                        started,
                        "cancel", "pwd", "stack c_ sum -out=summed"]), out)
    lines = out.getvalue().splitlines()
    status = [ln for ln in lines if ln.startswith("status:")]
    assert status == ["status: error stack", "status: success cancel",
                      "status: success pwd", "status: success stack"]
    assert "log: stack: cancelled" in lines
    assert [e["rc"] for e in s.command_log] == [1, 0, 0]
    assert (tmp_path / "summed.fit").exists()
    assert processing.processing_should_continue()


def test_interactive_loop_and_exit(tmp_path, caplog):
    import io

    from siril_tpu_torch.cli import interactive_loop, stdin_loop

    s = TSession(cwd=str(tmp_path), device="cpu")
    out = io.StringIO()
    caplog.set_level(logging.INFO, logger="siril_tpu_torch")
    interactive_loop(s, io.StringIO("log one\nexit\nlog two\n"), out)
    assert out.getvalue() == "> > "
    msgs = [r.getMessage() for r in caplog.records]
    assert "one" in msgs and "two" not in msgs and s.stop_requested
    s2 = TSession(cwd=str(tmp_path), device="cpu")
    caplog.clear()
    stdin_loop(s2, io.StringIO("log three\nexit\nlog four\n"))
    msgs = [r.getMessage() for r in caplog.records]
    assert "three" in msgs and "four" not in msgs
    # a script stops at exit
    (tmp_path / "x.ssf").write_text("log five\nexit\nlog six\n")
    from siril_tpu_torch.cli.parser import execute_script

    caplog.clear()
    assert execute_script(TSession(cwd=str(tmp_path), device="cpu"),
                          str(tmp_path / "x.ssf")) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert "five" in msgs and "six" not in msgs


@pytest.mark.parametrize("args", [["-p"], ["-i"], ["pwd"], []],
                         ids=["pipe", "interactive", "command", "stdin"])
def test_modes_need_a_card(monkeypatch, tmp_path, args):
    """Without a card and without ``--device cpu`` every mode raises;
    ``-v`` needs no device."""
    from siril_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["-d", str(tmp_path), *args])
    assert cli.run(["-v"]) is None


def test_log_fan_out():
    """The port's log records reach the hooks and the ring buffer."""
    from siril_tpu_torch.utils import log

    got = []
    hook = lambda lvl, msg: got.append((lvl, msg))  # noqa: E731
    log.add_log_hook(hook)
    try:
        logging.getLogger("siril_tpu_torch.x").info("fan %d", 1)
        logging.getLogger("siril_tpu_torch.x").error("fan %d", 2)
        logging.getLogger("other").error("not ours")
    finally:
        log.remove_log_hook(hook)
    assert got == [("info", "fan 1"), ("error", "fan 2")]
    assert log.get_log_buffer()[-2:] == ["fan 1", "fan 2"]
    old = list(log._buffer)
    try:
        log._buffer[:] = ["x"] * log._MAX_BUFFER
        logging.getLogger("siril_tpu_torch.x").info("over")
        assert len(log.get_log_buffer()) == log._MAX_BUFFER // 2 + 1
    finally:
        log._buffer[:] = old
