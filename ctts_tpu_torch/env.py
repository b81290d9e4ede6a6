"""Where the port runs: the CUDA device and a report of the toolchain."""

from __future__ import annotations

import shutil
import subprocess
import sys

import torch


def device() -> torch.device:
    """The CUDA device the port serves on. Raises when there is none:
    the port never falls back to the CPU on its own (tests pass
    torch.device("cpu") explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("ctts_tpu_torch: no CUDA device is available")
    return torch.device("cuda")


def _run(cmd: list) -> str:
    exe = shutil.which(cmd[0])
    if exe is None:
        return f"{cmd[0]}: not found"
    r = subprocess.run([exe] + cmd[1:], capture_output=True, text=True)
    out = (r.stdout or r.stderr).strip()
    return out if r.returncode == 0 else f"{cmd[0]} failed: {out}"


def nvcc_path() -> str:
    """nvcc from PATH, else the toolkit's default location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def report() -> dict:
    """Versions and device facts that every measurement is filed with."""
    cuda = torch.cuda.is_available()
    nvcc = nvcc_path()
    nvcc_version = _run([nvcc, "--version"]).splitlines()
    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": gpu_name_and_power_limit(),
        "nvcc": nvcc_version[-1] if nvcc_version else "",
    }
