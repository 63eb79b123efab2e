"""The yardstick of the benchmark's roofline shares: the H100's published
peaks (`peaks.json`) and frozen operation and byte counts of the port's
kernels (one module per kernel family)."""

from __future__ import annotations

import json
from pathlib import Path


def peaks() -> dict:
    return json.loads((Path(__file__).with_name("peaks.json")).read_text())
