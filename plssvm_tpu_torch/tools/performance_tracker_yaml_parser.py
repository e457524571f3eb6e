"""Parse the performance tracker's YAML into a table.

    python -m plssvm_tpu_torch.tools.performance_tracker_yaml_parser
        --tracking_file FILE [--csv]

The port's own copy of tools/performance_tracker_yaml_parser.py, with its
arguments.  It reads the two-level ``category: {name: value}`` schema that
the tracker (utils/tracker.py) writes, without PyYAML: each ``---``
document becomes one row of ``category.name`` columns.  ``--csv`` writes
CSV (RFC 4180 quoting, so a list value's commas stay in its column);
otherwise a pandas table where pandas is installed, else one block a
document.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Any, Dict, List


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if t.startswith('"') and t.endswith('"'):
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        # a flow-style list: split on the commas outside quotes (the writer
        # quotes strings that hold commas or colons)
        inner = t[1:-1].strip()
        if not inner:
            return []
        toks, buf, quoted = [], [], False
        for ch in inner:
            if ch == '"':
                quoted = not quoted
                buf.append(ch)
            elif ch == "," and not quoted:
                toks.append("".join(buf))
                buf = []
            else:
                buf.append(ch)
        toks.append("".join(buf))
        return [_parse_scalar(tok) for tok in toks]
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            continue
    if t in ("true", "false"):
        return t == "true"
    return t


def parse_tracking_file(filename: str) -> List[Dict[str, Any]]:
    """Each ``---`` document as one flat dict: 'category.name' -> value."""
    docs: List[Dict[str, Any]] = []
    current: Dict[str, Any] = {}
    category = None
    with open(filename, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if line.strip() == "---":
                if current:
                    docs.append(current)
                current = {}
                category = None
                continue
            if not line.strip():
                continue
            if not line.startswith(" "):
                key, _, value = line.partition(":")
                if value.strip() == "":
                    category = key.strip()
                else:
                    current[key.strip()] = _parse_scalar(value)
                    category = None
            else:
                key, _, value = line.strip().partition(":")
                prefix = f"{category}." if category else ""
                current[f"{prefix}{key.strip()}"] = _parse_scalar(value)
    if current:
        docs.append(current)
    return docs


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m plssvm_tpu_torch.tools.performance_tracker_yaml_parser",
        description="Tabulate the performance tracker's YAML documents.",
    )
    ap.add_argument("--tracking_file", required=True,
                    help="the YAML file storing the tracked performance")
    ap.add_argument("--csv", action="store_true", help="emit CSV instead of a table")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    docs = parse_tracking_file(args.tracking_file)
    if not docs:
        print("no tracking documents found", file=sys.stderr)
        return 1
    keys: List[str] = []
    for doc in docs:
        for key in doc:
            if key not in keys:
                keys.append(key)
    if args.csv:
        writer = csv.writer(sys.stdout, lineterminator="\n")
        writer.writerow(keys)
        for doc in docs:
            writer.writerow([str(doc.get(k, "")) for k in keys])
        return 0
    try:
        import pandas as pd
    except ImportError:
        for i, doc in enumerate(docs):
            print(f"--- document {i}")
            for key in keys:
                if key in doc:
                    print(f"  {key}: {doc[key]}")
        return 0
    print(pd.DataFrame(docs, columns=keys).to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
