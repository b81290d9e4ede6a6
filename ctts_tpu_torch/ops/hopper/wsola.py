"""WSOLA frame chain: CUDA kernel, plain version, launch count.

Counterpart of both ctts_tpu/ops/pallas/wsola.py kernels:
wsola_frames_batch (:515, S sentences in lockstep) and wsola_frames
(:573, one sentence). On Hopper one block runs one sentence's chain of
decisions to its own run count, so the two collapse into one kernel for
any B ≥ 1; a second, fully parallel launch writes the overlap-add
(csrc/wsola.cu). The plain version is ops/wsola.py wsola_frames_plain.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops.hopper.build import check, launch
from ctts_tpu_torch.ops.luts import hann
from ctts_tpu_torch.ops.wsola import FRAME, max_steps_for, wsola_frames_plain

KERNEL = "wsola_frames"
SOURCE = "ctts_tpu_torch/csrc/wsola.cu"
REPLACES = "ctts_tpu/ops/pallas/wsola.py:515"
GLOBALS = ("wsola_decide_kernel", "wsola_emit_kernel")

launches = 0


def _check_inputs(name, inp, sq, input_count, nrun):
    B, S = inp.shape
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    check(inp, "inp", torch.float32, (B, S), dev)
    check(sq, "sq", torch.float32, (B, S), dev)
    check(input_count, "input_count", torch.int32, (B,), dev)
    check(nrun, "nrun", torch.int32, (B,), dev)
    return B, S, dev


def wsola_frames(inp, sq, input_count, nrun, hop: int, out_size: int,
                 choices: dict | None = None):
    """inp, sq [B, S] f32 (int16-valued input, its energy_table);
    input_count, nrun [B] i32 -> (acc, norm) [B, out_size] f32. A
    `choices` dict receives pos [B, max_steps] i32, each frame's chosen
    input position (-1 past nrun), as wsola_frames_plain gives it."""
    global launches
    if inp.device.type == "cpu":
        return wsola_frames_plain(inp, sq, input_count, nrun, hop, out_size,
                                  choices=choices)
    B, S, dev = _check_inputs("wsola_frames", inp, sq, input_count, nrun)
    if hop < 1 or out_size < FRAME:
        raise ValueError(f"wsola_frames: hop {hop}, out_size {out_size}")
    steps = max_steps_for(S, out_size, hop)
    pos = torch.empty(B, steps, dtype=torch.int32, device=dev)
    acc = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    norm = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    launch("ctts_wsola_frames", dev, inp.data_ptr(), sq.data_ptr(),
           input_count.data_ptr(), nrun.data_ptr(),
           hann(FRAME, dev).data_ptr(), pos.data_ptr(), acc.data_ptr(),
           norm.data_ptr(), B, S, hop, out_size, steps)
    launches += 1
    if choices is not None:
        choices["pos"] = pos
    return acc, norm


def decide(inp, sq, input_count, nrun, max_steps: int, with_load: bool = True):
    """The decide launch alone (a measurement, not counted in
    `launches`): pos [B, max_steps] i32 as wsola_frames' `choices`. With
    `with_load` False it is the chain's latency floor: the ring in shared
    memory is filled once and nothing is fetched while the chain runs,
    so pos no longer follows the input."""
    B, S, dev = _check_inputs("decide", inp, sq, input_count, nrun)
    pos = torch.empty(B, max_steps, dtype=torch.int32, device=dev)
    launch("ctts_wsola_decide", dev, inp.data_ptr(), sq.data_ptr(),
           input_count.data_ptr(), nrun.data_ptr(), pos.data_ptr(), B, S,
           max_steps, int(with_load))
    return pos


def chain_floor(inp, sq, input_count, nrun, max_steps: int):
    """Latency floor of the frame chain on the card: decide() of nrun[b]
    frames with the window already in shared memory (only the steps that
    wait on the previous frame's choice). Needs CUDA tensors."""
    if inp.device.type != "cuda":
        raise ValueError(f"chain_floor: needs a CUDA tensor, not "
                         f"{inp.device}")
    return decide(inp, sq, input_count, nrun, max_steps, False)
