"""Calendar clock of the run loop (port of the JAX package's
`utils/clock.py`).

Model code works on ``time_s``, seconds since the run start; the clock
converts the configured start date into calendar quantities: WRF-format
timestamps for the log, the julian day of the start and the UTC seconds of
the day at the start for the solar ephemeris.  `Alarm` has the ring
semantics of an ESMF interval alarm.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt

WRF_FMT = "%Y-%m-%d_%H:%M:%S"


def parse_wrf_time(s: str) -> _dt.datetime:
    """Parse a WRF ISO timestamp ``YYYY-MM-DD_hh:mm:ss``."""
    return _dt.datetime.strptime(s, WRF_FMT)


def format_wrf_time(t: _dt.datetime) -> str:
    return t.strftime(WRF_FMT)


@dataclasses.dataclass
class Alarm:
    """Interval alarm: rings whenever model time crosses a multiple of
    ``interval_s`` past ``offset_s`` (a zero or negative interval never
    rings)."""

    interval_s: float
    offset_s: float = 0.0
    _last_ring: float = dataclasses.field(default=-1.0, repr=False)

    def is_ringing(self, time_s: float) -> bool:
        if self.interval_s <= 0.0:
            return False
        k = int((time_s - self.offset_s + 1e-6) // self.interval_s)
        ring_t = self.offset_s + k * self.interval_s
        if time_s + 1e-6 >= ring_t > self._last_ring:
            self._last_ring = ring_t
            return True
        return False


class ModelClock:
    """Run clock anchored at a calendar start date."""

    def __init__(self, start_date: str = "2000-06-21_12:00:00"):
        self.start = parse_wrf_time(start_date)

    def datetime_at(self, time_s: float) -> _dt.datetime:
        return self.start + _dt.timedelta(seconds=float(time_s))

    def timestamp(self, time_s: float) -> str:
        """WRF-format time of model time `time_s`."""
        return format_wrf_time(self.datetime_at(time_s))

    def julian_day(self, time_s: float = 0.0) -> float:
        t = self.datetime_at(time_s)
        jan1 = _dt.datetime(t.year, 1, 1)
        return (t - jan1).total_seconds() / 86400.0 + 1.0

    def utc_offset_s(self) -> float:
        """Seconds since UTC midnight at the run start, added to model
        ``time_s`` so that the solar hour angle follows the start time."""
        s = self.start
        return float(s.hour * 3600 + s.minute * 60 + s.second)
