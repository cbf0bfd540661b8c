"""Calendar clock of the run loop (port of the part of the JAX package's
`utils/clock.py` that `models.driver.Simulation` uses).

Model code works on ``time_s``, seconds since the run start; the clock
converts the configured start date into the two calendar quantities the
solar ephemeris needs: the julian day of the start and the UTC seconds of
the day at the start.  Alarms, timestamps and history names come with the
run infrastructure (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import datetime as _dt

WRF_FMT = "%Y-%m-%d_%H:%M:%S"


def parse_wrf_time(s: str) -> _dt.datetime:
    """Parse a WRF ISO timestamp ``YYYY-MM-DD_hh:mm:ss``."""
    return _dt.datetime.strptime(s, WRF_FMT)


class ModelClock:
    """Run clock anchored at a calendar start date."""

    def __init__(self, start_date: str = "2000-06-21_12:00:00"):
        self.start = parse_wrf_time(start_date)

    def datetime_at(self, time_s: float) -> _dt.datetime:
        return self.start + _dt.timedelta(seconds=float(time_s))

    def julian_day(self, time_s: float = 0.0) -> float:
        t = self.datetime_at(time_s)
        jan1 = _dt.datetime(t.year, 1, 1)
        return (t - jan1).total_seconds() / 86400.0 + 1.0

    def utc_offset_s(self) -> float:
        """Seconds since UTC midnight at the run start, added to model
        ``time_s`` so that the solar hour angle follows the start time."""
        s = self.start
        return float(s.hour * 3600 + s.minute * 60 + s.second)
