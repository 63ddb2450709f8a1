"""Date/time helpers — counterpart of ``siril_tpu/utils/dates.py``
(reference ``src/core/siril_date.c``): FITS DATE-OBS strings ⇄ datetime,
Julian date conversion.  Host code, copied.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Optional


def parse_date_obs(s: str) -> Optional[datetime]:
    """FITS DATE-OBS → datetime (FITS_date_to_date_time equivalent).
    Accepts 'YYYY-MM-DDTHH:MM:SS[.ffffff]' and date-only forms."""
    if not s:
        return None
    s = s.strip().strip("'\"")
    for fmt in ("%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
                "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime.strptime(s, fmt).replace(tzinfo=timezone.utc)
        except ValueError:
            continue
    return None


def format_date_obs(dt: datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def datetime_to_julian(dt: datetime) -> float:
    """Julian date (date_time_to_Julian equivalent, siril_date.c)."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    # days since the Julian epoch via the Unix epoch JD 2440587.5
    unix = dt.timestamp()
    return 2440587.5 + unix / 86400.0


def julian_to_datetime(jd: float) -> datetime:
    unix = (jd - 2440587.5) * 86400.0
    return datetime.fromtimestamp(unix, tz=timezone.utc)


def date_obs_to_julian(s: str) -> Optional[float]:
    dt = parse_date_obs(s)
    return datetime_to_julian(dt) if dt else None
