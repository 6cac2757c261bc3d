"""Data-sheet peaks of the card, chosen by its name (copied from the
port's ``chip_smoke.py::peak_rates``): H100 SXM 3.35 TB/s HBM and 989
TFLOP/s dense bf16; H100 PCIe 2.0 TB/s and 756. Rates at the full power
limit: the result line states the card's limit beside them."""

from __future__ import annotations

import subprocess


def peak_rates(name: str) -> tuple[float, float]:
    """(HBM bytes/s, dense bf16 operations/s)."""
    if "PCIe" in name:
        return 2.0e12, 756e12
    return 3.35e12, 989e12


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
