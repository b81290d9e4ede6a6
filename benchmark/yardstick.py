"""The benchmark's frozen arithmetic: the card's peaks, the roofline
bound, the WSOLA chain's least work, the percentile over all requests,
and the wrap that times a host call.

Copies, so that a later change to the port or to chip_smoke.py cannot
move what is measured:
  - HBM_BYTES_PER_S, CUDA_CORE_OPS_PER_S: chip_smoke.py:229-233;
  - bound: chip_smoke.py:788-796;
  - wsola_ops: chip_smoke.py:829-837, with FRAME and OVERLAP of
    ctts_tpu_torch/ops/wsola.py:33-36 written out here;
  - timed_method: chip_smoke.py:1335-1347, which logs each call's
    (start, end) here where it logged its duration.
What is new here counts the WSOLA work from what a served answer shows
(its length and speed), never from the kernel: wsola_work.
"""

from __future__ import annotations

import functools
import time

import numpy as np

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes/s, and the f32 rate outside the tensor cores, taken for the
# 32-bit integer and float work these kernels do on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

# WSOLA's frame geometry (ctts.c:3506-3510; ops/wsola.py:33-38).
FRAME = 512
AHOP = 128
OVERLAP = FRAME - AHOP
MAX_SHIFT = 128
FINE_REL = (-3, -2, -1, 1, 2, 3)
SAMPLE_RATE = 22050


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": float(ops)}


def wsola_ops(searched, nrun):
    """Operations the WSOLA chain needs on these inputs: 384 multiply-
    adds for each valid coarse and fine candidate its frames evaluate,
    and for every frame 512 window multiplies and 2 x 512 OLA adds."""
    return float((searched["coarse"] + searched["fine"]) * 2 * OVERLAP
                 + int(np.sum(nrun)) * 3 * FRAME)


def synthesis_hop(speed: float) -> int:
    """(size_t)(analysis_hop / clamped_speed), at least 1
    (ctts.c:3511-3512)."""
    s = min(max(np.float32(speed), np.float32(0.5)), np.float32(2.0))
    return max(int(np.float32(AHOP) / s), 1)


@functools.lru_cache(maxsize=4096)
def wsola_work(out_len: int, speed: float) -> tuple:
    """(frames, coarse, fine, input samples, output samples) that the
    WSOLA chain needs at least to give an answer `out_len` samples long
    at `speed`; (0, 0, 0, 0, 0) at speed 1.0 or for an empty answer.

    Each count is a lower bound read from the answer alone. The chain's
    live output is (frames - 1) * hop + FRAME samples, and the trim
    only drops trailing zeros, so frames >= ceil((out_len - FRAME) /
    hop) + 1; a frame k that runs reads k * AHOP + FRAME <= input
    samples. The coarse candidates counted are the offsets -128..128
    step 4 that fall inside that least input; the fine ones, for each
    frame, the fewest that any valid coarse choice leaves in range."""
    if abs(np.float32(speed) - np.float32(1.0)) < np.float32(0.01) \
            or out_len <= 0:
        return 0, 0, 0, 0, 0
    hop = synthesis_hop(speed)
    frames = max(-(-(out_len - FRAME) // hop), 0) + 1
    ic = (frames - 1) * AHOP + FRAME
    if frames < 2:
        return frames, 0, 0, ic, out_len
    k = np.arange(1, frames, dtype=np.int64)[:, None]
    nominal = k * AHOP

    def valid(off):
        pos = nominal + off
        return (pos >= 0) & (pos + FRAME <= ic)

    coarse_off = np.arange(-MAX_SHIFT, MAX_SHIFT + 1, 4)[None, :]
    cvalid = valid(coarse_off)
    coarse = int(cvalid.sum())
    fine_counts = np.zeros(cvalid.shape, np.int64)
    for r in FINE_REL:
        off = coarse_off + r
        fine_counts += ((np.abs(off) <= MAX_SHIFT) & valid(off))
    # No valid coarse candidate: the search stays at offset 0.
    at_zero = sum(valid(np.int64(r)) for r in FINE_REL)
    fine_min = np.where(cvalid, fine_counts, np.iinfo(np.int64).max)
    fine_min = np.where(cvalid.any(1), fine_min.min(1), at_zero[:, 0])
    return frames, coarse, int(fine_min.sum()), ic, out_len


def wsola_bound(out_lens, speed: float) -> dict:
    """The roofline bound of the WSOLA chain over served answers: each
    answer's input read once as f32 samples and its energy table, the
    Hann window once, and the OLA accumulators of its live output
    written once (chip_smoke.py:1183's byte count, from the answer's
    least input and output); its operations by wsola_ops."""
    frames = coarse = fine = ic = oc = 0
    for n in out_lens:
        f, c, fi, i, o = wsola_work(int(n), float(speed))
        frames, coarse, fine, ic, oc = (frames + f, coarse + c, fine + fi,
                                        ic + i, oc + o)
    nbytes = 2 * 4 * ic + 4 * FRAME + 2 * 4 * oc
    return dict(bound(nbytes, wsola_ops({"coarse": coarse, "fine": fine},
                                        frames)),
                frames=frames)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def timed_method(obj, name: str, log: list):
    """Wraps obj.<name> to append each call's host (start, end) seconds
    on the perf_counter clock to `log`; `del obj.<name>` restores it."""
    run = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        log.append((t0, time.perf_counter()))
        return out
    setattr(obj, name, call)
