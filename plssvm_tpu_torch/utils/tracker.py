"""Performance tracker: collect (category, name, value) entries, dump as YAML.

reference: include/plssvm/detail/performance_tracker.{hpp,cpp} — a global
multimap of ``tracking_entry{category,name,value}`` dumped as appended YAML
documents; pause/resume supported; the reference compiles it out unless
``PLSSVM_PERFORMANCE_TRACKER_ENABLED``.  Here it is always available but
cheap (a list append), and can be paused.

The YAML schema (categories: parameter, backend, data_set_read/scale/write,
transform, cg, model_write, total_time, ...) matches the reference's so the
analysis scripts keep working (reference: utility_scripts/
performance_tracker_yaml_parser.py).
"""

from __future__ import annotations

import datetime
import io
import sys
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple


class PerformanceTracker:
    """Global singleton collecting tracking entries."""

    def __init__(self) -> None:
        self._entries: "OrderedDict[str, List[Tuple[str, Any]]]" = OrderedDict()
        self._paused = False
        self._lock = threading.Lock()

    # -- collection ------------------------------------------------------
    def add(self, category: str, name: str, value: Any) -> None:
        if self._paused:
            return
        with self._lock:
            self._entries.setdefault(category, []).append((name, value))

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def is_paused(self) -> bool:
        return self._paused

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def entries(self) -> Dict[str, List[Tuple[str, Any]]]:
        return {k: list(v) for k, v in self._entries.items()}

    # -- output ----------------------------------------------------------
    def _format_value(self, value: Any) -> str:
        if isinstance(value, bool):
            return "true" if value else "false"
        if isinstance(value, (int, float)):
            return repr(value)
        if isinstance(value, (list, tuple)):
            return "[" + ", ".join(self._format_value(v) for v in value) + "]"
        s = str(value)
        if any(c in s for c in ":{}[]#,&*!|>'\"%@`") or s.strip() != s or s == "":
            return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
        return s

    def dump_yaml(self) -> str:
        """Render collected entries as one YAML document.

        Appended documents separated by ``---`` like the reference
        (performance_tracker.cpp save()).
        """
        out = io.StringIO()
        out.write("---\n")
        out.write(f'datetime: "{datetime.datetime.now().isoformat()}"\n')
        with self._lock:
            for category, kvs in self._entries.items():
                if category == "":
                    for name, value in kvs:
                        out.write(f"{name}: {self._format_value(value)}\n")
                    continue
                out.write(f"{category}:\n")
                for name, value in kvs:
                    if name == "":
                        out.write(f"  value: {self._format_value(value)}\n")
                    else:
                        out.write(f"  {name}: {self._format_value(value)}\n")
        return out.getvalue()

    def save(self, filename: Optional[str]) -> None:
        """Append the YAML document to ``filename`` or print to stderr.

        reference: performance_tracker.hpp save() — appends per-run documents.
        """
        text = self.dump_yaml()
        if filename:
            with open(filename, "a", encoding="utf-8") as fh:
                fh.write(text)
        else:
            sys.stderr.write(text)
        self.clear()


#: the global tracker instance (reference: global_tracker singleton)
global_tracker = PerformanceTracker()


def add_tracking_entry(category: str, name: str, value: Any) -> None:
    global_tracker.add(category, name, value)
