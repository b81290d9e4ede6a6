"""The packed output and its wire encode: CUDA kernel, plain version,
launch count.

The valid prefixes of a batch's int16 rows back to back (the packed
tail of ctts_tpu/parallel/batch.py:75-100) and, with the wire codec,
their encoding (encode_device, ctts_tpu/ops/wire.py:48). No Pallas
kernel computed them: on the TPU they were XLA ops. The plain version
is pack_rows, the pad to whole blocks and ops/wire.py's encode, in that
order; the kernel (csrc/pack_encode.cu) reads each valid sample once and
writes the packed samples, or the wire words and the block classes,
without a packed buffer in between, in one launch.
"""

from __future__ import annotations

import torch

from ctts_tpu_torch.ops import wire as wire_codec
from ctts_tpu_torch.ops.hopper.build import check, launch

KERNEL = "pack_encode"
SOURCE = "ctts_tpu_torch/csrc/pack_encode.cu"
REPLACES = "ctts_tpu/ops/wire.py:48"
GLOBALS = ("pack_encode_kernel",)

# The kernel's shared offsets hold B + 1 ints, and positions are ints.
MAX_ROWS = 8192
WARPS = 8   # wire blocks a thread block of the kernel

launches = 0


def pack_rows(out: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """Valid prefixes of out [B, OM] packed back to back into one flat
    buffer (ctts_tpu/parallel/batch.py:75-100): cumsum offsets and one
    index scatter; lanes past a row's length go to a dropped slot."""
    B, OM = out.shape
    lens = out_lens.long()
    offs = torch.cumsum(lens, 0) - lens
    iw = torch.arange(OM, device=out.device)
    tgt = torch.where(iw[None, :] < lens[:, None], offs[:, None] + iw, B * OM)
    packed = torch.zeros(B * OM + 1, dtype=out.dtype, device=out.device)
    packed.scatter_(0, tgt.reshape(-1), out.reshape(-1))
    return packed[:B * OM]


def pack_encode_plain(out: torch.Tensor, out_lens: torch.Tensor,
                      wire: bool):
    """pack_rows and, with the codec, the pad to whole blocks and
    wire.encode: (packed, None) or (words, classes)."""
    packed = pack_rows(out, out_lens)
    if not wire:
        return packed, None
    pad = -packed.shape[0] % wire_codec.WIRE_BLOCK
    if pad:
        packed = torch.cat([packed, packed.new_zeros(pad)])
    return wire_codec.encode(packed)


def pack_encode(out: torch.Tensor, out_lens: torch.Tensor, wire: bool):
    """out [B, OM] int16, out_lens [B] i32 (each in [0, OM]) -> wire
    off: (packed int16 [B*OM], None); wire on: (words int32 [5 * 64 *
    nblk], classes int32 [nblk]), nblk = ceil(B*OM / 512). Defined: the
    packed samples of the valid prefix (the kernel leaves the rest
    unwritten; the plain version zeroes it), the classes of every block,
    and the words of the valid prefix, wire.wire_valid_words(classes,
    sum(out_lens)) of them."""
    global launches
    if out.device.type == "cpu":
        return pack_encode_plain(out, out_lens, wire)
    if out.device.type != "cuda":
        raise ValueError(f"pack_encode: unsupported device {out.device}")
    B, OM = out.shape
    dev = out.device
    if not 0 < B <= MAX_ROWS or B * OM >= 2**31 - WARPS * 512:
        raise ValueError(f"pack_encode: {B} rows of {OM} outside the "
                         f"kernel's range ({MAX_ROWS} rows, 2^31 samples)")
    check(out, "out", torch.int16, (B, OM), dev)
    check(out_lens, "out_lens", torch.int32, (B,), dev)
    nblk = -(-B * OM // wire_codec.WIRE_BLOCK)
    if wire:
        payload = torch.empty(wire_codec.WIRE_PLANES * wire_codec.WIRE_CHUNK_W
                              * nblk, dtype=torch.int32, device=dev)
        classes = torch.empty(nblk, dtype=torch.int32, device=dev)
        status = torch.empty(-(-nblk // WARPS) + 1, dtype=torch.int64,
                             device=dev)
        ptrs = (0, payload.data_ptr(), classes.data_ptr(),
                status.data_ptr())
    else:
        payload = torch.empty(B * OM, dtype=torch.int16, device=dev)
        classes = None
        ptrs = (payload.data_ptr(), 0, 0, 0)
    launch("ctts_pack_encode", dev, out.data_ptr(), out_lens.data_ptr(),
           *ptrs, B, OM, int(wire))
    launches += 1
    return payload, classes
