"""What a measurement ran on: JAX's device and the card behind it."""

from __future__ import annotations

import shutil
import subprocess


def card_name_and_power() -> str | None:
    """`name, power.limit` of GPU 0 as nvidia-smi reports it, or None
    without nvidia-smi. Runs as a child process that never touches JAX (a
    second JAX process would reserve the card's memory)."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip() if out else None


def device_record() -> dict:
    """{platform, device_kind, device_count, card} for result lines."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card_name_and_power() if devs[0].platform == "gpu" else None,
    }
