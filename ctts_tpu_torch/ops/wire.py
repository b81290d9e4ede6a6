"""Lossless wire codec for the device-to-host audio transfer.

Counterpart of ctts_tpu/ops/wire.py, in the same format:

  1. second-order delta over the flat packed buffer (FLAC's fixed
     order-2 predictor), zigzag-mapped to non-negative;
  2. per 512-sample block, the residuals are stored as 1-5 nibble
     planes; the class (plane count) is the block's max residual width
     rounded up to 4 bits;
  3. selected (block, plane) chunks (512 nibbles = 64 int32 words each)
     are compacted block-major into one dense stream.

`encode` computes what the JAX `encode_device` computes, in PyTorch on
the tensor's device, not in the TPU's form: the compaction is a rank
(cumsum of the selection mask) and one index scatter of the selected
byte rows, where JAX runs a one-hot bf16 matmul over a scan of
256-row tiles. Only the valid prefix of the word stream,
`wire_valid_words(classes, n)` words for the first n samples, is
defined; the rest of the buffer is left unwritten. It is the codec of
the plain version of ops/hopper/pack_encode.py; on a card the serving
path encodes with that module's kernel, which writes the same words
straight from the unpacked rows.

The serving drain decodes a batch's shards in one native pass straight
into the rows' arrays (ops/wire_rows.py). `decode_host`, one streaming C
pass (`ctn_wire_decode` of the port's libctts_native.so, through
runtime/native.py), and `decode_np`, the plain NumPy decoder, are what
the tests hold that pass to.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

WIRE_BLOCK = 512     # samples per block
WIRE_PLANES = 5      # max nibble planes: |r| <= 131070 -> zigzag < 2^18
WIRE_CHUNK_W = WIRE_BLOCK // 8   # int32 words per chunk (8 nibbles/word)


def encode(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode an int16 buffer [L] on its device -> (wire int32
    [5 * L / 8], classes int32 [L / 512]). L must be a multiple of
    WIRE_BLOCK (the serving path pads the packed buffer to one)."""
    L = p.shape[0]
    if p.dtype != torch.int16 or p.dim() != 1 or L % WIRE_BLOCK:
        raise ValueError(f"wire.encode: want int16 [k*{WIRE_BLOCK}], got "
                         f"{p.dtype} {tuple(p.shape)}")
    nblk = L // WIRE_BLOCK
    x = p.to(torch.int32)
    r = x.clone()                              # block 0 starts from 0, 0
    r[1:] -= 2 * x[:-1]
    r[2:] += x[:-2]
    z = (r << 1) ^ (r >> 31)                   # zigzag (arithmetic >>)

    zb = z.view(nblk, WIRE_BLOCK)
    mx = zb.amax(dim=1)
    classes = (1 + (mx > 0xF).int() + (mx > 0xFF).int()
               + (mx > 0xFFF).int() + (mx > 0xFFFF).int())

    # Nibble planes -> byte rows: row b*5+p holds plane p of block b as
    # 256 bytes (lo nibble = even sample).
    ze, zo = zb[:, 0::2], zb[:, 1::2]
    rows = torch.stack(
        [(((ze >> (4 * pl)) & 0xF) | (((zo >> (4 * pl)) & 0xF) << 4))
         .to(torch.uint8) for pl in range(WIRE_PLANES)],
        dim=1).view(nblk * WIRE_PLANES, WIRE_BLOCK // 2)

    # Compaction: selected rows go to their rank; the rest to one
    # dropped row past the end.
    pl = torch.arange(WIRE_PLANES, device=p.device)
    mask = (pl[None, :] < classes[:, None]).view(-1)
    cap = nblk * WIRE_PLANES
    tgt = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
    out = torch.empty(cap + 1, WIRE_BLOCK // 2, dtype=torch.uint8,
                      device=p.device)
    out.index_copy_(0, tgt, rows)
    # 4 bytes -> one int32 word, read little-endian as the card and the
    # host store it (byte 3 >= 128 makes the word negative; the host
    # reads the words as uint32).
    return out[:cap].view(torch.int32).reshape(-1), classes


def wire_valid_words(classes: np.ndarray, valid_samples: int) -> int:
    """Host: int32 words covering the first `valid_samples` samples."""
    nblk_v = -(-int(valid_samples) // WIRE_BLOCK)
    return int(classes[:nblk_v].sum()) * WIRE_CHUNK_W


def decode_np(wire: np.ndarray, classes: np.ndarray,
              nsamples: int) -> np.ndarray:
    """NumPy reference decoder: wire int32 words + per-block classes ->
    int16 [nsamples]. Bit-exact inverse of encode_device."""
    if nsamples == 0:
        return np.zeros(0, np.int16)
    K = WIRE_BLOCK
    nblk = -(-nsamples // K)
    cls = np.asarray(classes[:nblk], np.int64)
    total = int(cls.sum())
    w = np.asarray(wire[: total * WIRE_CHUNK_W]).view(np.uint32)
    w = w.reshape(total, WIRE_CHUNK_W)
    ends = np.cumsum(cls)
    sel_b = np.repeat(np.arange(nblk), cls)
    sel_p = np.arange(total) - np.repeat(ends - cls, cls)

    widx = np.arange(K) // 8
    shifts = (4 * (np.arange(K) % 8)).astype(np.uint32)
    nib = ((w[:, widx] >> shifts[None, :]) & 0xF).astype(np.int32)

    z = np.zeros((nblk, K), np.int32)
    for pl in range(WIRE_PLANES):
        rows = sel_p == pl
        if rows.any():
            z[sel_b[rows]] |= nib[rows] << (4 * pl)
    z = z.reshape(-1)
    r = (z >> 1) ^ -(z & 1)
    with np.errstate(over="ignore"):
        x = np.cumsum(np.cumsum(r, dtype=np.int32), dtype=np.int32)
    return x[:nsamples].astype(np.int16)


def decode_host(wire: np.ndarray, classes: np.ndarray,
                nsamples: int) -> np.ndarray:
    """Decode with the native C pass (one streaming loop; the ctypes call
    releases the GIL, so the serving drain thread runs it beside the
    main thread). Raises when the library cannot be built, or when the
    pass rejects the input (a class outside 1..5)."""
    from ctts_tpu_torch.runtime.native import _load

    lib = _load()
    nblk = -(-int(nsamples) // WIRE_BLOCK)
    cls = np.ascontiguousarray(classes[:nblk], np.int32)
    need = wire_valid_words(cls, nsamples)
    w = np.ascontiguousarray(wire[:need], np.int32)
    if cls.shape[0] < nblk or w.shape[0] < need:
        raise ValueError(f"decode_host: {cls.shape[0]} classes and "
                         f"{w.shape[0]} words for {nsamples} samples "
                         f"({nblk} blocks, {need} words)")
    out = np.empty(nsamples, np.int16)
    got = lib.ctn_wire_decode(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nblk, nsamples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if got != nsamples:
        raise ValueError(f"ctn_wire_decode returned {got} for {nsamples} "
                         "samples (a class outside 1..5)")
    return out
