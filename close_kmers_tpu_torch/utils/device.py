"""Explicit torch device handling.

Every engine and the CLI take a device; nothing picks one silently.
``"cuda"`` without a card raises instead of running on the CPU, and
``"cpu"`` is the explicit mode in which every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a string or torch.device) as a torch.device.  There is
    no default: ``None`` raises, and so does ``"cuda"`` when
    ``torch.cuda.is_available()`` is false."""
    if device is None:
        raise ValueError('a device is required: "cuda" or "cpu"')
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() "
                "is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
