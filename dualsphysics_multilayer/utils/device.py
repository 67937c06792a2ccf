"""What the run is measured on: the JAX device and the card's power limit.

A GPU may be set below its maximum power and then runs slower under load,
so every reported time goes out beside the card's name and power limit.
The limit is read by ``nvidia-smi`` in a child process that never imports
JAX, so it holds no device memory."""

from __future__ import annotations

import shutil
import subprocess

import jax


def gpu_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (first card), or "not available" without nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "not available"


def device_record() -> dict:
    """The device as JAX reports it, for result lines."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """The device record; raises SystemExit unless JAX runs on a GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {rec['platform']} "
                         f"({rec['kind']}); measurements need the card")
    return rec
