"""Header substitution in paths — counterpart of
``siril_tpu/utils/pathparse.py`` (reference ``src/io/path_parse.c``):
``$KEY:fmt$`` tokens in a ``save`` path become the image's keyword
values, e.g. ``result_$LIVETIME:%d$s`` → ``result_3600s``
(scripts/OSC_Preprocessing.ssf:69).
"""

from __future__ import annotations

import re

_TOKEN = re.compile(r"\$([A-Za-z0-9_-]+)(?::([^$]+))?\$")

# keyword → Keywords attribute; any other key is looked up in ``extra``
_ATTRS = {
    "LIVETIME": "livetime", "STACKCNT": "stackcnt", "EXPTIME": "exposure",
    "OBJECT": "object", "FILTER": "filter", "INSTRUME": "instrume",
    "TELESCOP": "telescop", "OBSERVER": "observer", "DATE-OBS": "date_obs",
    "DATEOBS": "date_obs", "GAIN": "gain", "OFFSET": "offset",
    "CCD-TEMP": "ccd_temp",
}


def parse_path(template: str, img) -> str:
    """Expand the ``$KEY:fmt$`` tokens of ``template`` from ``img``'s
    keywords ("unknown" for a keyword the image lacks)."""

    def repl(m):
        key = m.group(1).upper()
        fmt = m.group(2) or "%s"
        kw = img.keywords
        attr = _ATTRS.get(key)
        val = getattr(kw, attr, None) if attr is not None else None
        if val is None:
            val = kw.extra.get(key)
        if val is None:
            return "unknown"
        try:
            if "d" in fmt:
                s = fmt % int(round(float(val)))
            elif any(c in fmt for c in "feg"):
                s = fmt % float(val)
            else:
                s = fmt % val
        except (TypeError, ValueError):
            s = str(val)
        # no colons, blanks or separators from the values (dates)
        return re.sub(r"[:\s/\\]+", "_", s)

    return _TOKEN.sub(repl, template)
