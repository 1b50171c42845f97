"""The card a measurement ran on, as the port's scripts print it beside
their numbers: its name and power limit, as

    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

gives them (a card set below its top power limit runs slower under load,
so a time means little without the limit)."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi(index: int = 0) -> str:
    """nvidia-smi's "name, power limit" line for card `index`; raises when
    nvidia-smi is missing or fails."""
    res = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_label(dev: torch.device) -> str:
    """The card's `nvidia_smi` line (its name alone when nvidia-smi is
    missing), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return nvidia_smi(index)
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)
