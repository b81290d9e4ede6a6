"""Build and load the Hopper kernels at first use.

Every ctts_tpu_torch/csrc/*.cu is compiled by its own nvcc process for
sm_90a (all started together), and the objects are linked into one
shared library with a plain C interface, ctts_tpu_torch/_build/
libctts_hopper.so, rebuilt when a source is newer, and loaded with
ctypes. No PyTorch headers are included, so a build takes seconds
(torch.utils.cpp_extension needs ninja and minutes). `--fmad=false`
keeps every f32 multiply and add separately rounded, as the sample
lattice requires. A failed build or load raises with nvcc's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

from ctts_tpu_torch.env import nvcc_path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libctts_hopper.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# Launcher signatures (csrc/*.cu): device pointers and the stream are
# void*, sizes are int; each returns its cudaError_t. The stream is the
# last argument, and launch() appends it.
SIGNATURES = {
    "ctts_pitch_corr": [_P, _P, _P, _P, _I, _P],
    "ctts_compose": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _P],
    "ctts_compact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ctts_silence_tables": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ctts_contour_zones": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctts_region_post": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    "ctts_assemble": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ctts_wsola_frames": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _P],
    "ctts_wsola_decide": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ctts_wsola_decide_table": [_P, _I, _P],
    "ctts_wsola_emit": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ctts_pack_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ctts_unit_base": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P],
    "ctts_unit_contrib": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _P],
    "ctts_empty": [_P],
    "ctts_current_device": [ctypes.POINTER(_I)],
}


class Kernel:
    """One kernel as ops/hopper lists it, where a module holds more than
    one: its name, source, the function it replaces, its __global__
    functions and its launch count (only a launch increments it)."""

    def __init__(self, kernel: str, source: str, replaces: str,
                 globals_: tuple):
        self.KERNEL = kernel
        self.SOURCE = source
        self.REPLACES = replaces
        self.GLOBALS = globals_
        self.launches = 0


class BuildInfo:
    """What the last build did (read by chip_smoke.py)."""

    seconds: float = 0.0
    log: str = ""
    built: bool = False


_lock = threading.Lock()
_lib = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    t = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > t for s in CSRC.iterdir())


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH when it is missing or stale: one
    nvcc per source, all running at once, then one link."""
    if not _stale():
        return LIB_PATH
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"rc {proc.returncode}: {' '.join(cmd)}\n{out}")
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = BUILD_DIR / f"libctts_hopper.{tag}.so"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"rc {r.returncode}: {' '.join(cmd)}\n"
                          f"{r.stdout}{r.stderr}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    BuildInfo.built = True
    return LIB_PATH


CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared"]


def gxx_build(src: Path, out: Path) -> Path:
    """Compile the host C++ source `src` with g++ into the shared library
    `out` when it is missing or older than the source (written under a
    name of this process's, then renamed, so that concurrent builds do
    not clash); a failed build raises with g++'s output."""
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.ctts_error_string.argtypes = [ctypes.c_int]
            handle.ctts_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def launch(name: str, device, *args) -> None:
    """Call a launcher for tensors on `device`: with that device current
    and, as the last argument, its current stream, so that the kernel
    runs in order with the eager ops on those tensors whichever device
    the caller has current. Raise on a nonzero cudaError_t (a refused
    launch never runs and a later synchronize would not report it)."""
    import torch

    handle = lib()
    with torch.cuda.device(device):
        _raise_on(handle, name, getattr(handle, name)(
            *args, stream_handle(device)))


def _raise_on(handle, name: str, rc: int) -> None:
    if rc != 0:
        msg = handle.ctts_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a kernel argument before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def empty_launch() -> None:
    """One launch of an empty kernel on the current device's stream: the
    launch floor that a kernel's time is read against (a measurement)."""
    import torch

    launch("ctts_empty", torch.device("cuda", torch.cuda.current_device()))


def stream_handle(device) -> int:
    """The current stream of `device`, the device of the tensors a kernel
    is launched for (not of the caller's current device)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def current_device() -> int:
    """The device the kernel library's CUDA runtime takes as current (it
    links cudart statically, beside PyTorch's own): equal to
    torch.cuda.current_device() when its launches follow the context
    that torch.cuda.device makes current (checked by chip_smoke.py)."""
    dev = ctypes.c_int(-1)
    handle = lib()
    _raise_on(handle, "ctts_current_device",
              handle.ctts_current_device(ctypes.byref(dev)))
    return dev.value
