"""The card a run uses, and what the result line says of it."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require(chips: int) -> None:
    """Refuse to run without ``chips`` CUDA cards: no CPU fallback."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card (torch.cuda.is_available() is false)")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards, {have} found")


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_limit_w()}
