"""Preferences — counterpart of ``siril_tpu/core/settings.py``
(``Preferences``:15, ``get``/``set``/``list_all``:69-95, INI load and
save :98-124, ``default_ini_path``:127, ``set_active``/``get_settings``
:139-144; the reference's ``struct pref_struct``, settings.h:395-453).

The same ``[core]`` INI at the same path
(``$XDG_CONFIG_HOME/siril_tpu/siril_tpu.ini``), so a user's settings
carry over between the two packages.  A ``cli.context.Session``'s
preferences are the active ones (``get_settings``): the stages that are
not handed a session (the debayer method, the live transport's
``online``, the memory budgets of ``utils/devmem``) read them there.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional


@dataclass
class Preferences:
    # memory management (settings.h:402-404)
    mem_mode: int = 0                  # 0=ratio, 1=amount
    memory_ratio: float = 0.9
    memory_amount: float = 10.0        # GB
    # FITS options
    ext: str = ".fit"
    force_16bit: bool = False
    fits_save_icc: bool = True
    comp_type: int = -1                # -1 = no compression
    comp_quantization: float = 16.0
    # networking (siril_networking.c online/offline mode)
    online: bool = False
    # debayer
    debayer_pattern: str = "RGGB"
    debayer_method: str = "rcd"
    debayer_top_down: bool = True
    # star finder (settings.h:296-308)
    sf_radius: int = 10
    sf_sigma: float = 1.0
    sf_roundness: float = 0.5
    sf_convergence: int = 1
    sf_profile: int = 0
    # photometry (settings.h phot_config)
    phot_gain: float = 2.3
    phot_inner: float = 20.0
    phot_outer: float = 30.0
    phot_aperture: float = 10.0
    phot_force_radius: bool = False
    phot_auto_aperture_factor: float = 2.0
    phot_minval: float = -1500.0
    phot_maxval: float = 60000.0
    # stacking defaults
    stack_method: int = 0
    stack_rejection: int = 5            # winsorized
    stack_sigma_low: float = 3.0
    stack_sigma_high: float = 3.0
    stack_norm: int = 0
    # astrometry
    astro_radius: float = 10.0
    astro_sip_order: int = 3
    wcs_formalism: int = 0
    # misc
    cpu_threads: int = 0                # 0 = auto
    script_check_requires: bool = True
    pipe_enabled: bool = False
    # script repository (settings.h:447-448)
    use_scripts_repository: bool = False
    auto_script_update: bool = False

    # ---- reflection get/set (settings.c table equivalent) ----
    def get(self, key: str) -> Any:
        key = key.replace(".", "_").replace("-", "_")
        for f in fields(self):
            if f.name == key:
                return getattr(self, f.name)
        raise KeyError(f"unknown setting '{key}'")

    def set(self, key: str, value: str) -> None:
        key2 = key.lstrip("-").replace(".", "_").replace("-", "_")
        for f in fields(self):
            if f.name == key2:
                cur = getattr(self, f.name)
                if isinstance(cur, bool):
                    setattr(self, f.name, str(value).lower() in
                            ("1", "true", "yes", "on"))
                elif isinstance(cur, int):
                    setattr(self, f.name, int(float(value)))
                elif isinstance(cur, float):
                    setattr(self, f.name, float(value))
                else:
                    setattr(self, f.name, str(value))
                return
        raise KeyError(f"unknown setting '{key}'")

    def list_all(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    # ---- INI persistence (initfile.c equivalent) ----
    def save_ini(self, path: Optional[str] = None) -> str:
        path = path or default_ini_path()
        cp = configparser.ConfigParser()
        cp["core"] = {k: str(v) for k, v in self.list_all().items()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            cp.write(f)
        return path

    @staticmethod
    def load_ini(path: Optional[str] = None) -> "Preferences":
        path = path or default_ini_path()
        p = Preferences()
        if not os.path.exists(path):
            return p
        cp = configparser.ConfigParser()
        cp.read(path)
        if "core" in cp:
            for k, v in cp["core"].items():
                try:
                    p.set(k, v)
                except KeyError:
                    pass
        return p


def default_ini_path() -> str:
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.expanduser("~/.config"))
    return os.path.join(base, "siril_tpu", "siril_tpu.ini")


# ---------------------------------------------------------------------------
# the active preferences (the reference's global com.pref): a Session makes
# its own active whenever it is given them (``cli/context.py``)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Preferences] = None


def set_active(prefs: Preferences) -> None:
    global _ACTIVE
    _ACTIVE = prefs


def get_settings() -> Preferences:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = Preferences()
    return _ACTIVE
