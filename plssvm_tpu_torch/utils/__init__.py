"""Utility subsystems: logging, performance tracking."""

from .logger import VerbosityLevel, get_verbosity, log, set_verbosity
from .tracker import PerformanceTracker, add_tracking_entry, global_tracker

__all__ = [
    "VerbosityLevel",
    "log",
    "set_verbosity",
    "get_verbosity",
    "PerformanceTracker",
    "global_tracker",
    "add_tracking_entry",
]
