"""Minimal 5-field cron schedule parser (minute hour dom month dow).

Supports: ``*``, numbers, lists (``a,b``), ranges (``a-b``), and steps
(``*/n``, ``a-b/n``). Semantics match the reference's robfig/cron usage in
pkg/controller/cronjob: dom and dow are OR'd when both are restricted.
"""

from __future__ import annotations

import calendar
import time
from typing import List, Set, Tuple

_BOUNDS = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step < 1:
                raise ValueError(f"bad step {step_s!r}")
        if part in ("*", ""):
            a, b = lo, hi
        elif "-" in part:
            a_s, b_s = part.split("-", 1)
            a, b = int(a_s), int(b_s)
        else:
            a = b = int(part)
        if a < lo or b > hi or a > b:
            raise ValueError(f"field {spec!r} out of range [{lo},{hi}]")
        out.update(range(a, b + 1, step))
    return out


class CronSchedule:
    def __init__(self, spec: str):
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields: {spec!r}")
        self.spec = spec
        (self.minutes, self.hours, self.dom, self.months, self.dow) = (
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _BOUNDS)
        )
        # dom/dow OR rule applies only when both are restricted
        self._dom_star = fields[2] == "*"
        self._dow_star = fields[4] == "*"

    def _day_matches(self, tm: time.struct_time) -> bool:
        dom_ok = tm.tm_mday in self.dom
        dow_ok = (tm.tm_wday + 1) % 7 in self.dow  # cron: 0=Sunday
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def next_after(self, ts: float, limit_days: int = 500) -> float:
        """Earliest scheduled time strictly after `ts` (unix seconds).

        Jumps by field instead of stepping minute-by-minute: non-matching
        months/days skip whole days, non-matching hours skip whole hours —
        bounded by ~limit_days day-steps even for never-matching specs
        ("0 0 31 2 *"), not 720k minute-steps."""
        t = int(ts // 60 + 1) * 60  # next whole minute
        deadline = ts + limit_days * 86400
        while t <= deadline:
            tm = time.localtime(t)
            if tm.tm_mon not in self.months or not self._day_matches(tm):
                # jump to next local midnight
                t = int(
                    time.mktime(
                        (tm.tm_year, tm.tm_mon, tm.tm_mday + 1, 0, 0, 0, 0, 0, -1)
                    )
                )
                continue
            if tm.tm_hour not in self.hours:
                # next LOCAL hour boundary — unix-hour arithmetic breaks in
                # zones with non-whole-hour offsets (e.g. +5:30)
                t = int(
                    time.mktime(
                        (tm.tm_year, tm.tm_mon, tm.tm_mday, tm.tm_hour + 1,
                         0, 0, 0, 0, -1)
                    )
                )
                continue
            if tm.tm_min in self.minutes:
                return float(t)
            # next matching minute within this hour, else next local hour
            later = [m for m in self.minutes if m > tm.tm_min]
            if later:
                t += (min(later) - tm.tm_min) * 60
            else:
                t = int(
                    time.mktime(
                        (tm.tm_year, tm.tm_mon, tm.tm_mday, tm.tm_hour + 1,
                         0, 0, 0, 0, -1)
                    )
                )
        raise ValueError(f"no run time within {limit_days} days for {self.spec!r}")
