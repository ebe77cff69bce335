"""Shared helpers of the benchmark's CPU tests: each cell at the tiny size
its ``workloads/<cell>.json`` gives under ``cpu_test``, so that a whole run
(set-up, window, reference comparison) fits a test."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tiny(cell) -> dict:
    """The cell's overrides for a CPU run: traffic, ``serve`` or ``train``
    parameters at a size the CPU holds."""
    return cell.workload["cpu_test"]
