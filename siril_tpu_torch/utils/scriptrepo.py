"""Script-repository sync — counterpart of ``siril_tpu/utils/scriptrepo.py``
(``sync_repository``:54, ``list_scripts``:97, ``script_search_paths``
:110, ``repo_path``:117; the reference's ``src/io/siril_git.c``).

The repository operations run through the system ``git`` binary
(clone, fetch, hard reset to FETCH_HEAD), gated by the
``use_scripts_repository`` preference (settings.h:447).  The URL is a
parameter, so a local ``file://`` repository serves offline; the
reference's URLs are the defaults.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import List, Optional

_log = logging.getLogger(__name__)

SCRIPT_REPOSITORY_URL = "https://gitlab.com/free-astro/siril-scripts"
SPCC_REPOSITORY_URL = "https://gitlab.com/free-astro/siril-spcc-database"

SCRIPT_EXTENSIONS = (".ssf", ".py")


def _git(args: List[str], cwd: Optional[str] = None,
         timeout: float = 120.0) -> subprocess.CompletedProcess:
    return subprocess.run(["git"] + args, cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def _remove_locks(repo_path: str) -> None:
    """remove_git_locks_by_path (siril_git.c:67): clear stale
    index.lock / *.lock files left by an interrupted sync."""
    git_dir = os.path.join(repo_path, ".git")
    if not os.path.isdir(git_dir):
        return
    for name in os.listdir(git_dir):
        if name.endswith(".lock"):
            try:
                os.unlink(os.path.join(git_dir, name))
            except OSError:
                pass


def sync_repository(url: str, local_path: str,
                    reset: bool = True) -> bool:
    """auto_update_gitscripts (siril_git.c:215+): clone if absent, else
    fetch + hard-reset to FETCH_HEAD (the reference deliberately
    discards local edits so the script list matches the repo).
    Returns True when the local tree is in sync."""
    if shutil.which("git") is None:
        _log.error("git binary not found — script repository disabled")
        return False
    try:
        if not os.path.isdir(os.path.join(local_path, ".git")):
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            r = _git(["clone", "--depth", "1", url, local_path])
            if r.returncode != 0:
                lines = r.stderr.strip().splitlines()
                _log.error("script repository clone failed: "
                           + (lines[-1] if lines else f"rc={r.returncode}"))
                return False
            _log.info(f"script repository cloned: {local_path}")
            return True
        _remove_locks(local_path)
        # verify the remote matches (siril_git.c:529 checks origin URL)
        r = _git(["remote", "get-url", "origin"], cwd=local_path)
        if r.returncode == 0 and r.stdout.strip() != url:
            _log.error(f"script repository remote mismatch: "
                       f"{r.stdout.strip()} != {url}")
            return False
        r = _git(["fetch", "origin"], cwd=local_path)
        if r.returncode != 0:
            _log.error("script repository fetch failed")
            return False
        if reset:
            r = _git(["reset", "--hard", "FETCH_HEAD"], cwd=local_path)
            if r.returncode != 0:
                _log.error("script repository reset failed")
                return False
        _log.info("script repository updated")
        return True
    except (subprocess.TimeoutExpired, OSError) as e:
        _log.error(f"script repository sync failed: {e}")
        return False


def list_scripts(local_path: str) -> List[str]:
    """All runnable scripts in the synced repository (the reference
    fills its script menu from *.ssf and *.py files, siril_git.c
    fill_script_repo_list)."""
    out = []
    for root, dirs, files in os.walk(local_path):
        dirs[:] = [d for d in dirs if d != ".git"]
        for f in sorted(files):
            if f.lower().endswith(SCRIPT_EXTENSIONS):
                out.append(os.path.join(root, f))
    return sorted(out)


def script_search_paths(prefs) -> List[str]:
    """Directories the script runner looks in: the user's configured
    folders plus the synced repository when enabled."""
    paths = list(getattr(prefs, "script_paths", []) or [])
    if getattr(prefs, "use_scripts_repository", False):
        repo = repo_path()
        if os.path.isdir(repo):
            paths.append(repo)
    return paths


def repo_path() -> str:
    base = os.environ.get("XDG_DATA_HOME",
                          os.path.expanduser("~/.local/share"))
    return os.path.join(base, "siril_tpu", "scripts-repo")
