"""The unit stage (ops/hopper/units.py: unit_base and unit_contrib)
against the JAX package and a NumPy walk of the kernels, on the CPU.

(a) The plain versions inside SynthesisCore equal the JAX core's stages
    (build_core under CTTS_STAGE_RAW=1: "contrib", the contributions of
    the initial heads; "head_pitch"; "heads1", the heads after one refine
    trip) on the plans of tests/test_device_executor.py's texts: bit for
    bit against the JAX core run op by op, and within 1 LSB against it
    jitted, where XLA:CPU contracts the LUT lerp of the crossfade curve
    into a fused multiply-add (tests/test_torch_ops.py).
(b) walk_unit_base and walk_unit_contrib, NumPy walks of what each
    thread of csrc/units.cu computes per element (each curve evaluated
    per unit, base recomputed from the bank), equal the plain versions
    bit for bit on adversarial unit slots: inactive units, units shorter
    than CFMAX and of length 0, crossfades longer than the unit, CFMAX
    wider than the bank (base zero-padded), a fade-in wider than CFMAX,
    remove_dc off, fade-in together with a crossfade, and heads that
    differ from base (a refine trip's).
(c) The wrappers run the plain versions on the CPU and count no launch;
    other devices raise; the core calls unit_base once and unit_contrib
    once a trip and once in the epilogue. On a CUDA card the kernels
    equal the plain versions at the serving bucket and on (b)'s cases.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctts_tpu_torch.ops.hopper import units as hunits
from ctts_tpu_torch.synth.dsp_np import (
    FADE_IN_LUT,
    FADE_OUT_LUT,
    SINE_FADE_LUT,
)
from ctts_tpu_torch.synth.plan_arrays import shared_plan_values

F32 = np.float32
PITCH_SPAN = 495


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


# -- (b): NumPy walks and adversarial units ---------------------------------

def lut(table, t):
    """fast_fade_* lookup with linear interpolation, in f32."""
    t = np.asarray(t, F32)
    idx_f = (t * F32(1023)).astype(F32)
    idx = idx_f.astype(np.int64)
    ic = np.clip(idx, 0, 1022)
    frac = (idx_f - ic.astype(F32)).astype(F32)
    val = (table[ic] * (F32(1) - frac)).astype(F32) \
        + (table[ic + 1] * frac).astype(F32)
    val = np.where(idx >= 1023, table[1023], val)
    return np.where(idx < 0, table[0], val).astype(F32)


def q16(x):
    return np.trunc(np.clip(x, F32(-32768), F32(32767))).astype(F32)


def unit_row(bank, gains, lengths, uid_raw):
    """(n, base row at the bank's width) of one unit slot."""
    uid = max(int(uid_raw), 0)
    n = min(int(lengths[uid]), bank.shape[1]) if uid_raw >= 0 else 0
    return n, q16((bank[uid] * gains[uid]).astype(F32))


def walk_unit_base(bank, gains, lengths, unit_id, cf_in, CFMAX, HW,
                   remove_dc):
    """What each block of unit_base_kernel computes, per column."""
    B, U = unit_id.shape
    UBUF = bank.shape[1]
    heads = np.zeros((B, U, CFMAX), F32)
    hcols = np.zeros((B, U, HW), F32)
    fo, fi = np.zeros_like(heads), np.zeros_like(heads)
    tail = np.zeros((B, U), np.int32)
    c = np.arange(max(CFMAX, HW))
    for b in range(B):
        for u in range(U):
            n, row = unit_row(bank, gains, lengths, unit_id[b, u])
            col = np.where(c < UBUF, np.pad(row, (0, max(0, len(c) - UBUF)))
                           [:len(c)], F32(0))
            hcols[b, u] = col[:HW]
            heads[b, u] = col[:CFMAX]
            inv = F32(1) / F32(max(int(cf_in[b, u]), 1))
            t = (np.arange(CFMAX).astype(F32) * inv).astype(F32)
            fo[b, u] = lut(FADE_OUT_LUT, t)
            fi[b, u] = lut(FADE_IN_LUT, t)
            if remove_dc:
                tail[b, u] = row[CFMAX:n].astype(np.int64).sum()
    return heads, hcols, tail, fo, fi


def walk_unit_contrib(heads, bank, gains, lengths, unit_id, cf_in, fade_in,
                      tail_total, fi, fade_in_samples, remove_dc):
    """What each block of unit_contrib_kernel computes, per column."""
    B, U, CFMAX = heads.shape
    UBUF = bank.shape[1]
    W = max(UBUF, CFMAX)
    out = np.zeros((B, U, W), F32)
    c = np.arange(W)
    for b in range(B):
        for u in range(U):
            n, row = unit_row(bank, gains, lengths, unit_id[b, u])
            h = heads[b, u]
            dcf = F32(0)
            if remove_dc:
                total = int(np.trunc(h[:min(n, CFMAX)]).astype(np.int64)
                            .sum()) + int(tail_total[b, u])
                q = abs(total) // max(n, 1)
                dcf = F32(q if total > 0 else -q)
            head = c < CFMAX
            src = np.where(head, np.pad(h, (0, W - CFMAX)),
                           np.pad(row, (0, W - UBUF)))
            x = src.astype(F32)
            if remove_dc:
                x = np.clip((x - dcf).astype(F32), F32(-32768), F32(32767))
            fade = min(n, fade_in_samples)
            if fade_in[b, u]:
                inv = F32(1) / F32(max(fade, 1))
                g = lut(SINE_FADE_LUT, (c.astype(F32) * inv).astype(F32))
                x = np.where(c < fade, np.trunc((x * g).astype(F32)), x)
            else:
                mix = head & (c < cf_in[b, u])
                x = np.where(mix, (x * np.pad(fi[b, u], (0, W - CFMAX)))
                             .astype(F32), x)
            out[b, u] = np.where(c < n, x, F32(0))
    return out


# name -> (UBUF, CFMAX, fade_in_samples, remove_dc)
UNIT_CASES = {
    "default": (2048, 1024, 66, True),
    "remove_dc off": (2048, 1024, 66, False),
    "CFMAX > UBUF": (2048, 4608, 66, True),
    "fade-in > CFMAX": (2048, 1024, 6615, True),
    "CFMAX < pitch span": (2048, 256, 66, True),
    "odd widths": (2046, 1022, 300, True),
}


# The serving bucket's unit stage: B = 128, U = 32, a bank of 840 units.
SERVING = (7168, 1024, 66, True)


def unit_inputs(case, seed, B=4, U=12, N=24):
    """A bank of N units (int16 values, zero padding past each length;
    lengths 0, under CFMAX and full), gains 0.1-3, and unit slots with
    every kind: inactive (-1), crossfades longer than the unit, fade-in
    with and without a crossfade."""
    UBUF, CFMAX, fis, remove_dc = UNIT_CASES.get(case, SERVING)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, UBUF + 1, N).astype(np.int32)
    lengths[:4] = (0, 1, min(CFMAX - 3, UBUF), UBUF)
    bank = rng.integers(-32768, 32768, (N, UBUF)).astype(F32)
    bank[np.arange(UBUF)[None, :] >= lengths[:, None]] = 0.0
    gains = rng.uniform(0.1, 3.0, N).astype(F32)
    gains[4] = F32(3.0)                       # clamps at +-32767/-32768
    unit_id = rng.integers(0, N, (B, U)).astype(np.int32)
    unit_id[rng.random((B, U)) < 0.2] = -1
    unit_id[0, :6] = (-1, 0, 1, 2, 3, 4)
    cf_in = rng.integers(0, CFMAX + 1, (B, U)).astype(np.int32)
    cf_in[0, 6:] = (0, 1, CFMAX, CFMAX, 7, 3)
    fade_in = rng.random((B, U)) < 0.4
    fade_in[0, 8:10] = True                   # fade-in with a crossfade
    shared = shared_plan_values(
        {"unit_cf_in": cf_in, "unit_id": unit_id}, lengths,
        SimpleNamespace(fade_in_samples=fis))
    W, HW = hunits.widths(UBUF, CFMAX, PITCH_SPAN)
    return dict(bank=bank, gains=gains, lengths=lengths, unit_id=unit_id,
                cf_in=cf_in, fade_in=fade_in, CFMAX=CFMAX, HW=HW, W=W,
                fis=fis, remove_dc=remove_dc, **shared)


def tensors(d, device=None):
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, np.ndarray) else v for k, v in d.items()}


def base_args(t):
    return (t["bank"], t["gains"], t["lengths"], t["unit_id"], t["cf_in"],
            t["cf_values"], t["CFMAX"], t["HW"], t["remove_dc"])


def contrib_args(t, heads, tail, fi):
    return (heads, t["bank"], t["gains"], t["lengths"], t["unit_id"],
            t["cf_in"], t["fade_in"], tail, fi, t["fade_values"], t["fis"],
            t["remove_dc"])


def trip_heads(heads, seed):
    """Heads as a refine trip leaves them: some units' columns replaced
    by other int16 values."""
    rng = np.random.default_rng(seed)
    h = heads.copy()
    pick = rng.random(h.shape[:2]) < 0.5
    h[pick] = rng.integers(-32768, 32768, (int(pick.sum()), h.shape[2]))
    return h


def bits(a):
    return np.asarray(a, F32).view(np.int32)


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_numpy_walk_of_unit_base_equals_plain(case):
    d = unit_inputs(case, 1)
    got = walk_unit_base(d["bank"], d["gains"], d["lengths"], d["unit_id"],
                         d["cf_in"], d["CFMAX"], d["HW"], d["remove_dc"])
    want = hunits.unit_base_plain(*base_args(tensors(d)))
    for name, g, w in zip(("heads", "hcols", "tail_total", "fo", "fi"),
                          got, want):
        w = w.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), name
    if d["remove_dc"] and d["CFMAX"] < d["bank"].shape[1]:
        assert want[2].abs().sum() > 0         # units with a body


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_numpy_walk_of_unit_contrib_equals_plain(case):
    d = unit_inputs(case, 2)
    t = tensors(d)
    heads, _, tail, _, fi = hunits.unit_base_plain(*base_args(t))
    for h in (heads.numpy(), trip_heads(heads.numpy(), 3)):
        got = walk_unit_contrib(h, d["bank"], d["gains"], d["lengths"],
                                d["unit_id"], d["cf_in"], d["fade_in"],
                                tail.numpy(), fi.numpy(), d["fis"],
                                d["remove_dc"])
        want = hunits.unit_contrib_plain(
            *contrib_args(t, torch.as_tensor(h), tail, fi)).numpy()
        assert want.shape == (4, 12, d["W"])
        assert np.array_equal(bits(got), bits(want))
        assert np.abs(want).max() > 0


def slot_lengths(d):
    return np.where(d["unit_id"] >= 0,
                    d["lengths"][np.maximum(d["unit_id"], 0)], 0)


def test_adversarial_units_take_every_branch():
    """The cases reach what they are meant to: a fade-in over body
    columns, base zero-padded past the bank, crossfades longer than
    their unit, inactive and empty units written as zeros."""
    d = unit_inputs("fade-in > CFMAX", 2)
    n = slot_lengths(d)
    assert (d["fade_in"] & (n > d["CFMAX"] + 10)).any()
    assert (d["cf_in"] > n).any() and (n == 0).any()
    assert ((n > 0) & (n < d["CFMAX"])).any()
    t = tensors(d)
    heads, _, tail, _, fi = hunits.unit_base_plain(*base_args(t))
    out = hunits.unit_contrib_plain(*contrib_args(t, heads, tail, fi))
    assert not out[torch.as_tensor(n == 0)].any()
    d = unit_inputs("CFMAX > UBUF", 2)
    heads, hcols, _, _, _ = hunits.unit_base_plain(*base_args(tensors(d)))
    assert heads.shape[-1] == hcols.shape[-1] == 4608
    assert heads[..., :2048].any() and not heads[..., 2048:].any()


# -- (a): the core's plain versions against the JAX core --------------------

TEXTS = ["como vai", "que legal!", "como se chama?", "bom dia. tudo bem.",
         "oi xz oi"]


@pytest.fixture(scope="module")
def setting(voice_db):
    from ctts_tpu.config import config_defaults
    from ctts_tpu.db.reader import VoiceDatabase
    from ctts_tpu.synth.device import DeviceVoice as JVoice
    from ctts_tpu_torch.synth.device import DeviceVoice, SynthesisCore

    db = VoiceDatabase(voice_db)
    jv = JVoice(db)
    tv = DeviceVoice.from_numpy(np.asarray(jv.bank), np.asarray(jv.lengths),
                                np.asarray(jv.gains), torch.device("cpu"))
    return db, config_defaults(), jv, SynthesisCore(tv), tv


def jax_stages(db, config, jv, text, jit):
    """The JAX core's contrib, head_pitch and heads1 stages of one
    sentence at its own dims."""
    import os

    from ctts_tpu.plan.compiler import compile_plan
    from ctts_tpu.synth import device as jdev

    plan = compile_plan(db, text, config, None, 1.0)
    dims = jdev.derive_dims(jdev.walk_plan(plan, db), db)
    arrays = {k: jnp.asarray(v) for k, v in
              jdev.build_device_plan(plan, db, dims).arrays.items()}
    old = os.environ.get("CTTS_STAGE_RAW")
    os.environ["CTTS_STAGE_RAW"] = "1"
    try:
        out = {}
        for stage in ("contrib", "head_pitch", "heads1"):
            core = jdev.build_core.__wrapped__(dims, jv.ubuf, stage=stage)
            if jit:
                core = jax.jit(core)
            out[stage] = np.asarray(core(jv.bank, jv.lengths, jv.gains,
                                         arrays)[0])
    finally:
        if old is None:
            del os.environ["CTTS_STAGE_RAW"]
        else:
            os.environ["CTTS_STAGE_RAW"] = old
    return plan, out


def port_stages(db, core, tv, plan):
    """The port's contributions of the initial heads, head pitch and
    heads after one refine trip, on the same plan at the same dims."""
    from ctts_tpu_torch.synth import plan_arrays as tpa

    w = tpa.walk_plan(plan, db)
    dims = tpa.derive_dims(w, db)
    dp = tpa.fill_device_plan(w, db, dims)
    ar = {k: torch.as_tensor(np.asarray(v)[None])
          for k, v in dp.arrays.items()}
    ar.update({k: torch.as_tensor(v) for k, v in shared_plan_values(
        dp.arrays, tv.lengths_np, dims).items()})
    st = core.prologue(dims, ar)
    contrib = core._contrib(dims, st)
    _, seg, tail = core._compose(dims, st["ar"], contrib, st["fo"], True)
    heads1 = core._boundary_heads(dims, st["ar"], st["hcols"], seg, tail)
    return {"contrib": contrib[0].numpy(),
            "head_pitch": st["ar"]["_next_pitch"][0].numpy(),
            "heads1": heads1[0].numpy()}


def test_plain_equals_the_jax_stages_op_by_op(setting):
    db, config, jv, core, tv = setting
    plan, want = jax_stages(db, config, jv, TEXTS[0], jit=False)
    got = port_stages(db, core, tv, plan)
    for stage in want:
        assert got[stage].shape == want[stage].shape, stage
        assert np.array_equal(got[stage], want[stage]), stage


@pytest.mark.parametrize("text", TEXTS[1:])
def test_plain_within_an_lsb_of_the_jitted_jax_stages(setting, text):
    db, config, jv, core, tv = setting
    plan, want = jax_stages(db, config, jv, text, jit=True)
    got = port_stages(db, core, tv, plan)
    for stage in want:
        assert got[stage].shape == want[stage].shape, stage
        assert np.abs(got[stage] - want[stage]).max(initial=0) <= 1.0, stage
    # Integer-valued contributions (no crossfade weight) are equal.
    whole = np.trunc(want["contrib"]) == want["contrib"]
    assert np.array_equal(got["contrib"][whole], want["contrib"][whole])
    assert np.array_equal(got["head_pitch"], want["head_pitch"])


# -- (c): routing --------------------------------------------------------------

def test_cpu_route_runs_the_plain_versions_and_counts_nothing():
    d = unit_inputs("default", 4)
    t = tensors(d)
    before = (hunits.base_kernel.launches, hunits.contrib_kernel.launches)
    got = hunits.unit_base(*base_args(t))
    want = hunits.unit_base_plain(*base_args(t))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    heads, _, tail, _, fi = got
    args = contrib_args(t, heads, tail, fi)
    assert torch.equal(hunits.unit_contrib(*args),
                       hunits.unit_contrib_plain(*args))
    assert (hunits.base_kernel.launches,
            hunits.contrib_kernel.launches) == before


def test_other_devices_raise():
    d = unit_inputs("default", 4)
    t = tensors(d, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hunits.unit_base(*base_args(t))
    heads = torch.empty((4, 12, d["CFMAX"]), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hunits.unit_contrib(*contrib_args(t, heads, t["unit_id"], heads))


def test_the_core_calls_both_wrappers(setting, monkeypatch):
    """The prologue makes its state with one unit_base; each refine trip
    and the epilogue make their contributions with one unit_contrib."""
    from ctts_tpu_torch.synth import compiled, device

    db, config, _, core, tv = setting
    from ctts_tpu.plan.compiler import compile_plan

    calls = {"unit_base": 0, "unit_contrib": 0}

    def spy(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(device, name, wrapper)

    spy("unit_base", hunits.unit_base)
    spy("unit_contrib", hunits.unit_contrib)
    plan = compile_plan(db, "como se chama?", config, None, 1.0)
    dims, arrays, shared = device.lower_sentence(plan, db, tv)
    compiled.run_eager(core, dims, arrays, shared, False)
    trips = device.refine_depth(arrays)
    assert trips >= 1
    assert calls == {"unit_base": 1, "unit_contrib": trips + 1}


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(UNIT_CASES) + ["serving"])
def test_kernels_match_plain_on_card(cuda_device, case):
    d = (unit_inputs(case, 5, B=128, U=32, N=840) if case == "serving"
         else unit_inputs(case, 5))
    t = tensors(d, cuda_device)
    before = hunits.base_kernel.launches
    got = hunits.unit_base(*base_args(t))
    assert hunits.base_kernel.launches == before + 1
    want = hunits.unit_base_plain(*base_args(t))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    heads, _, tail, _, fi = want
    for h in (heads, torch.as_tensor(trip_heads(heads.cpu().numpy(), 6),
                                     device=cuda_device)):
        args = contrib_args(t, h, tail, fi)
        before = hunits.contrib_kernel.launches
        out = hunits.unit_contrib(*args)
        assert hunits.contrib_kernel.launches == before + 1
        plain = hunits.unit_contrib_plain(*args)
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
