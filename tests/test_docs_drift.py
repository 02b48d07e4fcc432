"""Docs drift check: every throughput figure in the README and docs/ must
name the card it was measured on and that card's power limit.

A figure is a number followed by a rate unit (GB/s, MB/s, symbols/s,
Gsym/s, Msym/s, ...).  It passes only if the same line, or the line just
before it (for figures wrapped across a line break), names an H100 and a
power limit in watts (``700 W``).  Numbers from another chip, from a CPU
run, or from no run at all therefore cannot stand in the docs.
"""

import os
import re

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_NUM = r"\d+(?:[.,]\d+)*"
RATE = re.compile(
    rf"{_NUM}\s*(?:[kMGT]?B/s|[kMG]?sym(?:bol)?s?/s|symbols per second)",
    re.IGNORECASE,
)
CARD = re.compile(r"H100")
POWER = re.compile(r"\b\d{2,4}(?:\.\d+)?\s*W\b")


def _doc_files():
    yield os.path.join(ROOT, "README.md")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "docs")):
        for f in sorted(files):
            if f.endswith(".md"):
                yield os.path.join(dirpath, f)


def test_gbps_claims_match_generated_table():
    offenders = []
    for path in _doc_files():
        lines = open(path, encoding="utf-8").read().splitlines()
        for i, ln in enumerate(lines):
            if not RATE.search(ln):
                continue
            ctx = (lines[i - 1] if i else "") + " " + ln
            if not (CARD.search(ctx) and POWER.search(ctx)):
                offenders.append(
                    f"{os.path.relpath(path, ROOT)}:{i + 1}: {ln.strip()!r}")
    assert not offenders, (
        "throughput figures that do not name an H100 and its power limit:\n"
        + "\n".join(offenders)
    )
