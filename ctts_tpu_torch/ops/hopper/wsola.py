"""WSOLA frame chain: CUDA kernels, plain versions, launch counts.

Counterpart of both ctts_tpu/ops/pallas/wsola.py kernels:
wsola_frames_batch (:515, S sentences in lockstep) and wsola_frames
(:573, one sentence). On Hopper one block runs one sentence's chain of
decisions to its own run count, so the two collapse into one kernel for
any B ≥ 1; a second, fully parallel launch writes the overlap-add
(csrc/wsola.cu). The plain versions are ops/wsola.py's
wsola_frames_plain, decide_plain and emit_plain.

Two ways to run the chain: wsola_frames, the decide and the emit of one
bucket; or, across the stretch buckets of a serving batch (synth/
compiled.py Pending), decide_table, one decide launch over every
bucket's rows, then emit per bucket. The module counts the emit's
launches (KERNEL), decide_kernel the decide's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ctts_tpu_torch.ops.hopper.build import Kernel, check, launch
from ctts_tpu_torch.ops.luts import hann
from ctts_tpu_torch.ops.wsola import (
    FRAME,
    decide_plain,
    emit_plain,
    max_steps_for,
    wsola_frames_plain,
)

KERNEL = "wsola_frames"
SOURCE = "ctts_tpu_torch/csrc/wsola.cu"
REPLACES = "ctts_tpu/ops/pallas/wsola.py:515"
GLOBALS = ("wsola_emit_kernel",)

launches = 0
decide_kernel = Kernel("wsola_decide", SOURCE, REPLACES,
                       ("wsola_decide_kernel",))

# Segments a decide_table launch takes (csrc/wsola.cu kMaxSegments).
MAX_SEGMENTS = 32


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
    decide_kernel.launches += 1
    if choices is not None:
        choices["pos"] = pos
    return acc, norm


class Segment(NamedTuple):
    """One bucket's rows in a decide_table launch: inp, sq [B, S] f32
    and input_count, nrun [B] i32 as wsola_frames takes them, and pos
    [B, max_steps] i32, which receives the chosen positions."""

    inp: torch.Tensor
    sq: torch.Tensor
    input_count: torch.Tensor
    nrun: torch.Tensor
    pos: torch.Tensor


class _Segment(ctypes.Structure):
    """csrc/wsola.cu WsolaSegment."""

    _fields_ = [("inp", ctypes.c_void_p), ("sq", ctypes.c_void_p),
                ("input_count", ctypes.c_void_p), ("nrun", ctypes.c_void_p),
                ("pos", ctypes.c_void_p), ("rows", ctypes.c_int),
                ("S", ctypes.c_int), ("max_steps", ctypes.c_int)]


def decide_table(segments) -> None:
    """Each Segment's pos as wsola_frames' choices gives it. On a card
    one decide launch a MAX_SEGMENTS segments (_tables), a block a row
    of every segment: the chains run side by side, so a launch takes
    about its longest chain's time, not one chain's time a segment. On
    the CPU decide_plain, one segment at a time. Every segment lies on
    one device."""
    if not segments:
        return
    dev = segments[0].inp.device
    if dev.type == "cpu":
        for s in segments:
            s.pos.copy_(decide_plain(s.inp, s.sq, s.input_count, s.nrun,
                                     s.pos.shape[1]))
        return
    for s in segments:
        B, _, _ = _check_inputs("decide_table", s.inp, s.sq, s.input_count,
                                s.nrun)
        if s.inp.device != dev:
            raise ValueError(f"decide_table: segments on {dev} and "
                             f"{s.inp.device}")
        check(s.pos, "pos", torch.int32, (B, s.pos.shape[1]), dev)
    for table in _tables(segments):
        launch("ctts_wsola_decide_table", dev, ctypes.addressof(table),
               len(table))
        decide_kernel.launches += 1


def _tables(segments) -> list:
    """The parameter tables of decide_table's launches: every segment
    once, the widest first (the blocks of the longest chains start
    first), at most MAX_SEGMENTS a table."""
    rows = sorted((_Segment(s.inp.data_ptr(), s.sq.data_ptr(),
                            s.input_count.data_ptr(), s.nrun.data_ptr(),
                            s.pos.data_ptr(), *s.inp.shape, s.pos.shape[1])
                   for s in segments), key=lambda r: -r.S)
    chunks = [rows[i:i + MAX_SEGMENTS]
              for i in range(0, len(rows), MAX_SEGMENTS)]
    return [(_Segment * len(c))(*c) for c in chunks]


def emit(inp, pos, nrun, hop: int, out_size: int):
    """The overlap-add alone from chosen positions pos [B, max_steps] i32
    (a decide_table's): (acc, norm) [B, out_size] f32 as wsola_frames
    gives them. emit_plain on the CPU."""
    global launches
    if inp.device.type == "cpu":
        return emit_plain(inp, pos, nrun, hop, out_size)
    B, S = inp.shape
    dev = inp.device
    check(inp, "inp", torch.float32, (B, S), dev)
    check(nrun, "nrun", torch.int32, (B,), dev)
    steps = max_steps_for(S, out_size, hop)
    check(pos, "pos", torch.int32, (B, steps), dev)
    if hop < 1 or out_size < FRAME:
        raise ValueError(f"emit: hop {hop}, out_size {out_size}")
    acc = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    norm = torch.empty(B, out_size, dtype=torch.float32, device=dev)
    launch("ctts_wsola_emit", dev, inp.data_ptr(), pos.data_ptr(),
           nrun.data_ptr(), hann(FRAME, dev).data_ptr(), acc.data_ptr(),
           norm.data_ptr(), B, S, hop, out_size, steps)
    launches += 1
    return acc, norm


def decide(inp, sq, input_count, nrun, max_steps: int, with_load: bool = True):
    """The decide launch of one bucket alone (a measurement, not counted
    in the launch counts): pos [B, max_steps] i32 as wsola_frames'
    `choices`. With `with_load` False it is the chain's latency floor:
    the ring in shared memory is filled once and nothing is fetched
    while the chain runs, so pos no longer follows the input."""
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
