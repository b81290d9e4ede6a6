"""WSOLA frame chain: CUDA kernel, plain version, launch count.

Counterpart of both ctts_tpu/ops/pallas/wsola.py kernels:
wsola_frames_batch (:515, S sentences in lockstep) and wsola_frames
(:573, one sentence). On Hopper one block runs one sentence's chain to
its own run count, so the two collapse into one kernel for any B ≥ 1.
The plain version is ops/wsola.py wsola_frames_plain.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import check, launch, stream_handle
from ctts_tpu_torch.ops.luts import hann
from ctts_tpu_torch.ops.wsola import FRAME, wsola_frames_plain

KERNEL = "wsola_frames"
SOURCE = "ctts_tpu_torch/csrc/wsola.cu"
REPLACES = "ctts_tpu/ops/pallas/wsola.py:515"

launches = 0


def wsola_frames(inp, sq, input_count, nrun, hop: int, out_size: int):
    """inp, sq [B, S] f32 (int16-valued input, its energy_table);
    input_count, nrun [B] i32 -> (acc, norm) [B, out_size] f32."""
    global launches
    if inp.device.type == "cpu":
        return wsola_frames_plain(inp, sq, input_count, nrun, hop, out_size)
    if inp.device.type != "cuda":
        raise ValueError(f"wsola_frames: unsupported device {inp.device}")
    B, S = inp.shape
    dev = inp.device
    check(inp, "inp", torch.float32, (B, S), dev)
    check(sq, "sq", torch.float32, (B, S), dev)
    check(input_count, "input_count", torch.int32, (B,), dev)
    check(nrun, "nrun", torch.int32, (B,), dev)
    if hop < 1 or out_size < FRAME:
        raise ValueError(f"wsola_frames: hop {hop}, out_size {out_size}")
    acc = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    norm = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    launch("ctts_wsola_frames", inp.data_ptr(), sq.data_ptr(),
           input_count.data_ptr(), nrun.data_ptr(),
           hann(FRAME, dev).data_ptr(), acc.data_ptr(), norm.data_ptr(),
           B, S, hop, out_size, stream_handle())
    launches += 1
    return acc, norm


def chain_floor(inp, nrun, with_load: bool):
    """Microbenchmark of the frame chain's latency floor on the card
    (csrc/wsola.cu wsola_chain_floor_kernel): nrun[b] frames of only the
    steps that wait on the previous frame's choice, plus the window load
    from global memory when `with_load`. Not on the serving path, so
    not counted in `launches`. inp [B, S] f32, nrun [B] i32 (CUDA) ->
    [B] i32, the last tail index of each row."""
    B, S = inp.shape
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError(f"chain_floor: needs a CUDA tensor, not {dev}")
    check(inp, "inp", torch.float32, (B, S), dev)
    check(nrun, "nrun", torch.int32, (B,), dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    launch("ctts_wsola_chain_floor", inp.data_ptr(), nrun.data_ptr(),
           out.data_ptr(), B, S, int(with_load), stream_handle())
    return out
