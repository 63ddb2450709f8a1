"""Update check — counterpart of ``siril_tpu/utils/update.py``
(``parse_version``:37, ``compare_version``:73, ``newest_release``:100,
``check_for_updates``:131; the reference's ``src/core/siril_update.c``):
fetch ``siril_versions.json``, compare the newest release against the
running version with the reference's major.minor.micro + rc/beta/patch
ordering, and report.

The fetch goes through the transport seam of the remote catalogues
(``astrometry/remote.py``): a transport with a ``get(url)`` method —
``FixtureTransport`` offline, the live transport only when online.
Parsing and comparison are pure.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Optional, Tuple

SIRIL_VERSIONS_URL = "https://siril.org/siril_versions.json"
CURRENT_VERSION = "1.5.0"          # tracks the reference parity target


@dataclass
class VersionNumber:
    """version_number (siril_update.c:93)."""

    major: int = 0
    minor: int = 0
    micro: int = 0
    patched: int = 0
    rc: bool = False
    beta: bool = False


def parse_version(text: str) -> VersionNumber:
    """get_version_number_from_string: first numeric onward, split on
    '.' and '-'; a 4th field starting with rc/beta flags a prerelease,
    otherwise it is a patch number."""
    v = VersionNumber()
    m = re.search(r"\d", text or "")
    if not m:
        return v
    parts = re.split(r"[.\-]", text[m.start():])

    def num(s: str) -> int:
        m2 = re.match(r"\d+", s)
        return int(m2.group()) if m2 else 0

    v.major = num(parts[0])
    if len(parts) < 2:
        return v
    v.minor = num(parts[1])
    if len(parts) < 3:
        return v
    v.micro = num(parts[2])
    if len(parts) >= 4:
        extra = parts[3]
        if extra.startswith("beta"):
            v.beta = True
            v.patched = num(extra[4:])
        elif extra.startswith("rc"):
            v.rc = True
            v.patched = num(extra[2:])
        else:
            v.patched = num(extra)
    return v


def compare_version(v1: VersionNumber, v2: VersionNumber) -> int:
    """compare_version (siril_update.c:131): −1/0/1; release > rc >
    beta at equal x.y.z; patch numbers compared within the same
    channel."""
    for a, b in ((v1.major, v2.major), (v1.minor, v2.minor),
                 (v1.micro, v2.micro)):
        if a < b:
            return -1
        if a > b:
            return 1
    if v1.beta and v2.rc:
        return -1
    if v2.beta and v1.rc:
        return 1
    if v1.beta and not (v2.rc or v2.beta):
        return -1
    if v1.rc and not (v2.rc or v2.beta):
        return -1
    if v2.rc and not (v1.rc or v1.beta):
        return 1
    if v2.beta and not (v1.rc or v1.beta):
        return 1
    if v1.patched < v2.patched:
        return -1
    if v1.patched > v2.patched:
        return 1
    return 0


def newest_release(versions_json: bytes,
                   include_prerelease: bool = False
                   ) -> Optional[Tuple[str, VersionNumber]]:
    """Pick the highest version from a siril_versions.json document
    ({"siril": {"stable": "x.y.z", "beta": "..."}} or a flat list)."""
    if isinstance(versions_json, str):
        versions_json = versions_json.encode("utf-8")
    try:
        doc = json.loads(versions_json.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    candidates = []
    if isinstance(doc, dict):
        node = doc.get("siril", doc)
        if isinstance(node, dict):
            for key, val in node.items():
                if isinstance(val, str):
                    if not include_prerelease and key not in ("stable",
                                                              "release"):
                        continue
                    candidates.append(val)
        elif isinstance(node, list):
            candidates = [str(x) for x in node]
    elif isinstance(doc, list):
        candidates = [str(x) for x in doc]
    best = None
    for c in candidates:
        pv = parse_version(c)
        if best is None or compare_version(pv, best[1]) > 0:
            best = (c, pv)
    return best


def check_for_updates(transport,
                      current: str = CURRENT_VERSION,
                      include_prerelease: bool = False) -> str:
    """check_version_update equivalent: returns the user-facing
    message.  ``transport.get(url) -> bytes`` is injected (online mode
    gating lives at the call site, like remote catalogues)."""
    try:
        payload = transport.get(SIRIL_VERSIONS_URL)
    except Exception as e:       # network failure is a soft error
        return f"unable to check for updates: {e}"
    best = newest_release(payload, include_prerelease)
    if best is None:
        return "unable to check for updates: bad version document"
    name, pv = best
    cmp = compare_version(parse_version(current), pv)
    if cmp < 0:
        return f"new version available: {name} (running {current})"
    return f"siril_tpu is up to date ({current})"
