"""Verbosity-levelled logging.

reference: include/plssvm/detail/logger.hpp:33-123 — a global bitmask
``verbosity_level`` {quiet, libsvm, timing, full} gates every log line; log
calls that carry tracking entries also feed the performance tracker.
"""

from __future__ import annotations

import enum
import sys
from typing import Any, Union


class VerbosityLevel(enum.IntFlag):
    """Bitmask verbosity levels (reference: detail/logger.hpp:33-45)."""

    QUIET = 0
    #: print libsvm-conforming output lines (e.g. "optimization finished, #iter = N")
    LIBSVM = 0b001
    #: print timing information
    TIMING = 0b010
    #: print everything
    FULL = 0b100

    @classmethod
    def from_string(cls, value: Union[str, "VerbosityLevel"]) -> "VerbosityLevel":
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        mapping = {"quiet": cls.QUIET, "libsvm": cls.LIBSVM, "timing": cls.TIMING, "full": cls.FULL}
        if s not in mapping:
            raise ValueError(f"Unrecognized verbosity level '{value}'!")
        return mapping[s]

    def __str__(self) -> str:
        for name in ("quiet", "full", "timing", "libsvm"):
            if self == VerbosityLevel.from_string(name):
                return name
        return "|".join(m.name.lower() for m in VerbosityLevel if m and m in self)


#: global verbosity, like the reference's ``plssvm::verbosity`` global
_verbosity: VerbosityLevel = VerbosityLevel.FULL


def set_verbosity(level: Union[str, VerbosityLevel]) -> None:
    global _verbosity
    _verbosity = VerbosityLevel.from_string(level) if isinstance(level, str) else level


def get_verbosity() -> VerbosityLevel:
    return _verbosity


def log(level: VerbosityLevel, message: str, *args: Any, **kwargs: Any) -> None:
    """Print ``message`` if the global verbosity admits ``level``.

    Semantics follow reference detail/logger.hpp:108-123: with FULL verbosity
    everything prints; otherwise a line prints if its level shares a bit with
    the global verbosity.
    """
    if _verbosity == VerbosityLevel.QUIET:
        return
    effective = level
    if VerbosityLevel.FULL in _verbosity:
        show = True
    else:
        show = bool(effective & _verbosity)
    if show:
        text = message.format(*args, **kwargs) if (args or kwargs) else message
        print(text, end="", file=sys.stdout)
        sys.stdout.flush()
