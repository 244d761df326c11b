"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device.

    Without a GPU the default raises instead of falling back to the CPU: a
    CPU run is something the caller asks for (``device="cpu"``), never a
    silent substitute for the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them; a
    card set below its maximum power runs slower under load, so every time
    kept is kept beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
