"""The packed output and its wire encode (ops/hopper/pack_encode.py)
against the JAX package and a NumPy walk of the kernel, on the CPU.

pack_encode_plain (pack_rows, the pad, wire.encode: what the CPU runs)
must equal, on every case: with the codec, JAX's encode_device on the
NumPy-packed buffer padded to whole blocks (the classes on every block,
the words over wire_valid_words); without it, the NumPy-packed buffer
(zeros past the valid prefix); and decode_np and decode_host must give
the samples back. walk_pack_encode, a NumPy walk of what each thread of
csrc/pack_encode.cu computes (the row of each packed position from the
offsets, the residual across rows, the class per block, the rank of
each block's planes from the classes before it, and the thread blocks
past the total that write class 1 and nothing else), must equal the
plain version bit for bit. The cases: rows of length 0, 1 and 2;
residuals at every class edge (zigzag 0xF / 0x10, 0xFF / 0x100,
0xFFF / 0x1000, 0xFFFF / 0x10000 and the largest, class 5) made across
a row boundary; a total that is a multiple of 512 (the block after it
holds the residuals of the last two samples) and one that is not;
B*OM that is not a multiple of 512; no sample at all. On a CUDA card
the kernel must equal the plain version at the serving bucket (B = 128,
OM = 114688 and the stretched 78976), at B = 1 and on these cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu.ops import wire as jwire
from ctts_tpu_torch.ops import wire as twire
from ctts_tpu_torch.ops.hopper import pack_encode as hpe

K = twire.WIRE_BLOCK
CHUNK_W = twire.WIRE_CHUNK_W
WARPS = hpe.WARPS


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# Samples x[p-2], x[p-1], x[p] among zeros whose largest zigzagged
# residual is the class edge: a spike h gives residuals h, -2h, h (the
# largest 4h - 1 for h > 0, 4|h| for h < 0); the last is the largest
# residual there is, 32767 + 65536 + 32767.
EDGES = {0xF: (0, 0, 4), 0x10: (0, 0, -4), 0xFF: (0, 0, 64),
         0x100: (0, 0, -64), 0xFFF: (0, 0, 1024), 0x1000: (0, 0, -1024),
         0xFFFF: (0, 0, 16384), 0x10000: (0, 0, -16384),
         262140: (32767, -32768, 32767)}


def rows_from_stream(stream, lens, OM, rng):
    """out [B, OM] int16 whose valid prefixes (lens) are `stream` back to
    back; random samples past each length (they must not leak)."""
    B = len(lens)
    out = rng.integers(-32768, 32768, (B, OM)).astype(np.int16)
    ends = np.cumsum(lens)
    for b in range(B):
        out[b, :lens[b]] = stream[ends[b] - lens[b]:ends[b]]
    return out, np.asarray(lens, np.int32)


def edge_case(rng):
    """Every class edge in a block of its own, its sample x[p] the first
    of a row (so the residuals at p, p + 1 and p + 2 reach back into the
    rows before), with rows of length 0, 1 and 2 among them; the total
    is 12 blocks."""
    stream = np.zeros(12 * K, np.int16)
    cuts = []
    for i, (a, b, c) in enumerate(EDGES.values()):
        p = i * K + 200 + 7 * i
        stream[p - 2:p + 1] = (a, b, c)
        cuts.append(p)
    # Rows: one ends just before each edge sample; empty and short rows
    # between them.
    bounds = sorted(set(cuts + [cuts[2] + 1, cuts[3] + 2, cuts[5] + 1,
                                cuts[5] + 3, 12 * K]))
    lens = np.diff([0] + bounds).tolist()
    lens[3:3] = [0]
    lens[7:7] = [0, 0]
    OM = max(lens) + 5
    return rows_from_stream(stream, lens, OM, rng)


def ragged_case(rng, B=6, OM=1500):
    """Random speech-like rows with lengths 0, 1, 2 and the rest random:
    the total is not a multiple of 512 and B*OM is not either."""
    lens = [0, 1, 2] + rng.integers(3, OM + 1, B - 3).tolist()
    stream = np.cumsum(rng.integers(-700, 701, sum(lens))).clip(
        -32768, 32767).astype(np.int16)
    return rows_from_stream(stream, lens, OM, rng)


def cases():
    rng = np.random.default_rng(3)
    out = {"edges": edge_case(rng), "ragged": ragged_case(rng)}
    # B*OM = 3 * 1000: not a multiple of 512, every row full.
    full = rng.integers(-32768, 32768, 3000).astype(np.int16)
    out["odd B*OM, rows full"] = rows_from_stream(full, [1000] * 3, 1000,
                                                  rng)
    # A total that is a multiple of 512 with B*OM past it; the last
    # samples are extremes, so the block after the total has class 5.
    s = rng.integers(-3000, 3000, 2 * K).astype(np.int16)
    s[-2:] = (32767, -32768)
    out["total at a block edge"] = rows_from_stream(s, [700, 0, 2 * K - 700],
                                                    900, rng)
    out["no samples"] = rows_from_stream(np.zeros(0, np.int16), [0, 0, 0],
                                         700, rng)
    # Thread blocks past the total + 2: 9 wire blocks of rows, 2 of them
    # valid.
    s = rng.integers(-50, 50, 1000).astype(np.int16)
    out["blocks past the total"] = rows_from_stream(s, [1000, 0, 0, 0, 0],
                                                    1000, rng)
    return out


CASES = cases()


def numpy_packed(out, lens):
    return np.concatenate([out[b, :lens[b]] for b in range(len(lens))]
                          + [np.zeros(0, np.int16)])


def walk_pack_encode(out, lens, wire):
    """What csrc/pack_encode.cu computes, per packed position and per
    wire block: (packed prefix, None) or (words with -1 where no block
    wrote, classes)."""
    B, OM = out.shape
    nblk = -(-B * OM // K)
    L = np.clip(lens.astype(np.int64), 0, OM)
    off = np.concatenate([[0], np.cumsum(L)])
    total = int(off[-1])

    def x_at(p):
        p = np.asarray(p, np.int64)
        ok = (p >= 0) & (p < total)
        pc = np.clip(p, 0, max(total - 1, 0))
        r = np.searchsorted(off[1:], pc, side="right")   # off[r+1] > p
        r = np.minimum(r, B - 1)
        v = out[r, np.clip(pc - off[r], 0, OM - 1)].astype(np.int32)
        return np.where(ok, v, 0)

    if not wire:
        return x_at(np.arange(total)).astype(np.int16), None
    classes = np.zeros(nblk, np.int64)
    z = {}
    for k in range(nblk):
        first = (k // WARPS) * WARPS * K          # the thread block's start
        if first >= total + 2:
            classes[k] = 1
            continue
        x = x_at(np.arange(k * K - 2, (k + 1) * K))
        r = x[2:] - 2 * x[1:-1] + x[:-2]
        zk = ((r << 1) ^ (r >> 31)).astype(np.uint32)
        mx = int(zk.max())
        classes[k] = 1 + (mx > 0xF) + (mx > 0xFF) + (mx > 0xFFF) \
            + (mx > 0xFFFF)
        z[k] = zk
    rank = np.cumsum(classes) - classes
    words = np.full(5 * CHUNK_W * nblk, -1, np.int64)
    shifts = 4 * np.arange(8, dtype=np.uint32)
    for k, zk in z.items():
        for q in range(int(classes[k])):
            nib = ((zk >> np.uint32(4 * q)) & np.uint32(0xF)).reshape(
                CHUNK_W, 8)
            w = (nib << shifts[None, :]).sum(1).astype(np.uint32)
            at = (int(rank[k]) + q) * CHUNK_W
            words[at:at + CHUNK_W] = w.view(np.int32)
    return words, classes.astype(np.int32)


def plain(out, lens, wire):
    got = hpe.pack_encode_plain(torch.as_tensor(out), torch.as_tensor(lens),
                                wire)
    return tuple(None if t is None else t.numpy() for t in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_encode_and_decodes(name):
    out, lens = CASES[name]
    B, OM = out.shape
    total = int(lens.sum())
    packed = numpy_packed(out, lens)
    # Wire off: pack_rows, zeros past the valid prefix.
    got, none = plain(out, lens, False)
    assert none is None and got.shape == (B * OM,)
    assert np.array_equal(got[:total], packed)
    assert not got[total:].any()
    # Wire on: JAX's encode_device on the packed buffer, padded.
    xp = np.zeros(-(-B * OM // K) * K, np.int16)
    xp[:total] = packed
    jw, jc = map(np.asarray, jwire.encode_device(jnp.asarray(xp)))
    words, classes = plain(out, lens, True)
    assert np.array_equal(classes, jc)
    valid = twire.wire_valid_words(classes, total)
    assert valid == jwire.wire_valid_words(jc, total)
    assert np.array_equal(words[:valid], jw[:valid])
    assert np.array_equal(twire.decode_np(words, classes, total), packed)
    assert np.array_equal(twire.decode_host(words, classes, total), packed)


def zigzag_max(packed, nblk):
    x = np.zeros(nblk * K + 2, np.int64)
    x[2:2 + len(packed)] = packed
    r = x[2:] - 2 * x[1:-1] + x[:-2]
    return np.abs(np.where(r < 0, -2 * r - 1, 2 * r)).reshape(
        nblk, K).max(1)


def test_every_class_edge_lands_in_its_block():
    out, lens = CASES["edges"]
    assert zigzag_max(numpy_packed(out, lens), 12).tolist()[:len(EDGES)] \
        == list(EDGES)
    _, classes = plain(out, lens, True)
    want = [1 + (e > 0xF) + (e > 0xFF) + (e > 0xFFF) + (e > 0xFFFF)
            for e in EDGES]
    assert classes[:len(EDGES)].tolist() == want == [1, 2, 2, 3, 3, 4, 4,
                                                     5, 5]
    assert (lens <= 2).sum() >= 4 and (lens == 0).sum() >= 3
    # The block after a total at a block edge holds the last residuals.
    out, lens = CASES["total at a block edge"]
    _, classes = plain(out, lens, True)
    assert int(lens.sum()) == 2 * K and classes[2] == 5
    assert (classes[3:] == 1).all()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("wire", [False, True], ids=["packed", "wire"])
def test_numpy_walk_equals_plain(name, wire):
    out, lens = CASES[name]
    total = int(lens.sum())
    got, got_classes = walk_pack_encode(out, lens, wire)
    want, want_classes = plain(out, lens, wire)
    if not wire:
        assert np.array_equal(got, want[:total])
        return
    assert np.array_equal(got_classes, want_classes)
    valid = twire.wire_valid_words(want_classes, total)
    assert np.array_equal(got[:valid], want[:valid].astype(np.int64))


def test_cpu_route_runs_the_plain_version_and_counts_nothing():
    out, lens = CASES["ragged"]
    before = hpe.launches
    total = int(lens.sum())
    for wire in (False, True):
        got = hpe.pack_encode(torch.as_tensor(out), torch.as_tensor(lens),
                              wire)
        want = plain(out, lens, wire)
        if wire:
            n = twire.wire_valid_words(want[1], total)
            assert np.array_equal(got[1].numpy(), want[1])
        else:
            n = total
            assert got[1] is None
        assert np.array_equal(got[0].numpy()[:n], want[0][:n])
    assert hpe.launches == before


def test_other_devices_raise():
    out, lens = CASES["ragged"]
    with pytest.raises(ValueError, match="unsupported device"):
        hpe.pack_encode(torch.as_tensor(out).to("meta"),
                        torch.as_tensor(lens).to("meta"), True)


def test_the_compiled_core_calls_the_wrapper(monkeypatch):
    """synth/compiled.py's pack and encode, after the epilogue of every
    path (run_eager, the graphs, execute_plan_torch), is one pack_encode
    call with the core's out and out_lens and the wire flag."""
    from ctts_tpu_torch.synth import compiled

    seen = []

    def spy(out, out_lens, wire):
        seen.append((out, out_lens, wire))
        return hpe.pack_encode(out, out_lens, wire)

    monkeypatch.setattr(compiled, "pack_encode", spy)
    out, lens = (torch.as_tensor(x) for x in CASES["ragged"])
    ovf = torch.zeros(lens.shape, dtype=torch.int32)
    total = int(lens.sum())
    for wire in (False, True):
        got = compiled._pack_encode(out, lens, ovf, wire)
        assert seen[-1][0] is out and seen[-1][1] is lens
        assert seen[-1][2] is wire
        assert got[2] is lens and got[3] is ovf
        want = plain(out.numpy(), lens.numpy(), wire)
        n = twire.wire_valid_words(want[1], total) if wire else total
        assert np.array_equal(got[0].numpy()[:n], want[0][:n])
    assert len(seen) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def serving_rows(B, OM, seed):
    """B rows of OM with speech-like prefixes of random lengths (one
    empty, one of a sample), as the serving bucket holds them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(OM // 4, OM + 1, B)
    lens[:2] = (0, 1) if B > 2 else lens[:2]
    stream = np.cumsum(rng.integers(-900, 901, int(lens.sum()))).clip(
        -32768, 32767).astype(np.int16)
    return rows_from_stream(stream, lens, OM, rng)


CARD_CASES = {"serving 1.0": (128, 114688), "serving 1.5": (128, 78976),
              "one sentence": (1, 114688)}


def card_inputs(case, dev):
    if case in CARD_CASES:
        out, lens = serving_rows(*CARD_CASES[case], 7)
    else:
        out, lens = CASES[case]
    return torch.as_tensor(out, device=dev), torch.as_tensor(lens, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [False, True], ids=["packed", "wire"])
@pytest.mark.parametrize("case", sorted(CARD_CASES) + sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case, wire):
    out, lens = card_inputs(case, cuda_device)
    total = int(lens.sum())
    before = hpe.launches
    got, got_classes = hpe.pack_encode(out, lens, wire)
    assert hpe.launches == before + 1
    want, want_classes = hpe.pack_encode_plain(out, lens, wire)
    if not wire:
        assert got_classes is None
        assert torch.equal(got[:total], want[:total])
        return
    assert torch.equal(got_classes, want_classes)
    valid = twire.wire_valid_words(want_classes.cpu().numpy(), total)
    assert torch.equal(got[:valid], want[:valid])
