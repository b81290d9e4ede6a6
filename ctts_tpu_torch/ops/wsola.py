"""WSOLA time stretch for speed != 1.0 (parity: ctts.c:3378-3617).

Counterpart of ctts_tpu/ops/wsola_jax.py, batched over a leading
sentence dimension. What is computed, not how the TPU computed it: the
search numerators are exact int64 dot products (the JAX package's hi/lo
bf16 splits, window stacks, one-hot picks and circulants compute the
same integers), the candidate energies come from an exact sliding
table, and each output sample adds its frames in ascending frame order.
The chain is a Hopper kernel for a CUDA tensor (ops/hopper/wsola.py:
the decisions, then the overlap-add from the chosen positions) and
`wsola_frames_plain` below for a CPU tensor.

Exactness: every correlation numerator and energy is an exact integer
(< 2^39), rounded to f32 once; sq1*sq2 is one f32 multiply, its root
and the quotient are correctly rounded — the same f32 values as the
JAX package (combine_exact) and the NumPy oracle
(dsp_np.batched_cross_correlation), so the offset decisions agree bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ctts_tpu_torch.ops.exact import sqrt_rn
from ctts_tpu_torch.ops.luts import hann
from ctts_tpu_torch.ops.quant import q16, trunc16, wrap16

F32 = torch.float32

FRAME = 512
AHOP = 128              # analysis hop (75% overlap)
OVERLAP = FRAME - AHOP  # 384
MAX_SHIFT = 128         # ±25% of frame
WIN = FRAME + 2 * MAX_SHIFT  # 768: every candidate and frame of a step
NCOARSE = 65            # coarse offsets -128..128, step 4
FINE_REL = (-3, -2, -1, 1, 2, 3)


def synthesis_hop_for_speed(speed: float) -> int:
    """(size_t)(analysis_hop / clamped_speed), min 1 (ctts.c:3511-3512;
    ctts_tpu/ops/wsola_jax.py:177). Static per bucket."""
    s = min(max(np.float32(speed), np.float32(0.5)), np.float32(2.0))
    return max(int(np.float32(AHOP) / s), 1)


def sliding_sumsq(x: torch.Tensor, width: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Exact sliding-window energy of int16-valued rows x [B, N]:
    out[:, p] = f32(Σ_{i<width} x[:, p+i]²) for p = 0..N-width
    (ctts_tpu/ops/wsola_jax.py:57 _sliding_sumsq). The int64 cumsum is
    exact (N·2^30 < 2^63) and each window sum (< 2^39 < 2^53) is
    rounded to f32 once (into `out` where given)."""
    xi = x.to(torch.int64)
    cs = F.pad(torch.cumsum(xi * xi, dim=1), (1, 0))
    sums = cs[:, width:] - cs[:, :-width]
    return sums.to(F32) if out is None else out.copy_(sums)


def energy_table(inp: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """sq [B, S]: sq[:, p] = energy of the OVERLAP-sample window at
    input position p (zeros past the row's end) — the frame chain's
    sq1 (candidate) and sq2 (previous tail) lookups (written to `out`
    where given)."""
    return sliding_sumsq(F.pad(inp, (0, OVERLAP - 1)), OVERLAP, out)


def max_steps_for(S: int, out_size: int, hop: int) -> int:
    """Frame slots of the bucket (ctts_tpu/ops/wsola_jax.py:257-259):
    the input's frame count, capped by the output capacity."""
    steps = (S - FRAME) // AHOP + 2 if S > FRAME else 2
    return min(steps, (out_size - FRAME) // hop + 1)


def run_counts(input_count: torch.Tensor, S: int, out_size: int,
               hop: int) -> torch.Tensor:
    """nrun [B] i32: frames that run (ctts_tpu/ops/wsola_jax.py:252-276,
    :121). The run predicate is non-increasing in k, so the frames that
    run are the prefix [0, nrun) (ctts_tpu/ops/pallas/wsola.py:37-39)."""
    ic = input_count.to(torch.int64)[:, None]
    num_frames = torch.where(ic > FRAME, (ic - FRAME) // AHOP + 1, 1)
    alloc = num_frames * hop + FRAME + 1024
    ks = torch.arange(max_steps_for(S, out_size, hop), device=ic.device)
    run = ((ks * AHOP + FRAME <= ic) & (ks * hop + FRAME <= alloc)
           & (ks * hop + FRAME <= out_size))
    return run.sum(1).to(torch.int32)


def _first_argmax(v: torch.Tensor):
    """Row max of v [B, n] and the EARLIEST index holding it (an all
    -inf row gives index 0, as jnp.argmax does)."""
    m = v.max(1).values
    idx = torch.arange(v.shape[1], device=v.device)
    first = torch.where(v == m[:, None], idx, v.shape[1]).min(1).values
    return m, first


def _corr(cands, tail, sq1, sq2):
    """Normalized correlation of candidate windows cands [B, n, OVERLAP]
    (int64) with the tail [B, OVERLAP]: exact integer numerator rounded
    once, denom = sqrt_rn(sq1*sq2), 0 where denom < 1
    (ctts_tpu/ops/wsola_jax.py:303-314)."""
    num = (cands * tail[:, None, :]).sum(-1).to(F32)
    denom = sqrt_rn(sq1 * sq2[:, None])
    return torch.where(denom < 1.0, 0.0, num / denom)


def wsola_frames_plain(inp, sq, input_count, nrun, hop: int,
                       out_size: int, searched: dict | None = None,
                       choices: dict | None = None):
    """The WSOLA frame chain, plain PyTorch, batched over sentences:
    decide_plain's positions, then emit_plain's overlap-add.

    inp [B, S] f32 int16-valued, sq = energy_table(inp), input_count
    and nrun [B] i32. Returns the OLA accumulators (acc, norm)
    [B, out_size] f32: acc holds exact integer sums awaiting one
    wrap16. A `searched` dict receives the number of valid coarse and
    fine candidates the frames that run evaluate (the work these inputs
    need), and a `choices` dict receives pos [B, max_steps_for(S,
    out_size, hop)] i32, each frame's chosen input position (-1 for the
    frames that do not run)."""
    pos = decide_plain(inp, sq, input_count, nrun,
                       max_steps_for(inp.shape[1], out_size, hop), searched)
    if choices is not None:
        choices["pos"] = pos
    return emit_plain(inp, pos, nrun, hop, out_size)


def decide_plain(inp, sq, input_count, nrun, max_steps: int,
                 searched: dict | None = None):
    """The frame chain's decisions, plain PyTorch: pos [B, max_steps]
    i32, each frame's chosen input position (-1 for the frames past
    nrun). For k < nrun[b], in frame order (what
    ctts_tpu/ops/pallas/wsola.py:210-317, 373-399 computes): the tail
    is the OVERLAP samples at the previous chosen position + AHOP; the
    coarse search takes the earliest max of the normalized correlation
    over offsets -128..128 step 4 (invalid candidates -inf; none valid
    → offset 0, best -2); the fine search tries ±1..3 around it and
    moves only on a strict improvement; offset 0 at k = 0; the frame is
    clamped into [0, input_count-FRAME]. `searched` as in
    wsola_frames_plain."""
    B, S = inp.shape
    dev = inp.device
    pos = torch.full((B, max_steps), -1, dtype=torch.int32, device=dev)
    K = int(nrun.max()) if B else 0
    n_c = n_f = 0
    if K <= 0:
        if searched is not None:
            searched.update(coarse=0, fine=0)
        return pos
    # Padded coordinates: padded position p is input position
    # p - MAX_SHIFT, so step k's window is xp[:, k*AHOP : k*AHOP + WIN]
    # and its index j is offset j - MAX_SHIFT from the nominal position.
    xp = F.pad(inp, (MAX_SHIFT, FRAME + MAX_SHIFT)).to(torch.int64)
    sqp = F.pad(sq, (MAX_SHIFT, FRAME + MAX_SHIFT))
    ic = torch.clamp(input_count.to(torch.int64), max=S)[:, None]
    i_ov = torch.arange(OVERLAP, device=dev)
    j_c = torch.arange(NCOARSE, device=dev) * 4
    rel = torch.tensor(FINE_REL, device=dev)
    qo = torch.full((B,), MAX_SHIFT, dtype=torch.int64, device=dev)

    def valid(nominal, j):
        pos = nominal + j - MAX_SHIFT
        return (pos >= 0) & (pos + FRAME <= ic)

    for k in range(K):
        nominal = k * AHOP
        win = xp[:, nominal:nominal + WIN]
        off = torch.zeros(B, dtype=torch.int64, device=dev)
        if k > 0:
            tail = win.gather(1, qo[:, None] + i_ov)
            sq2 = sqp.gather(1, (nominal + qo)[:, None])[:, 0]
            corr_c = _corr(win.unfold(1, OVERLAP, 4)[:, :NCOARSE], tail,
                           sqp[:, nominal + j_c], sq2)
            corr_c = torch.where(valid(nominal, j_c[None, :]), corr_c,
                                 -torch.inf)
            best, bc = _first_argmax(corr_c)
            none_valid = torch.isneginf(best)
            best_off = torch.where(none_valid, 0, bc * 4 - MAX_SHIFT)
            best = torch.where(none_valid, -2.0, best)

            j_f = best_off[:, None] + MAX_SHIFT + rel
            ok = (j_f >= 0) & (j_f <= 2 * MAX_SHIFT) & valid(nominal, j_f)
            j_f = torch.clamp(j_f, 0, 2 * MAX_SHIFT)
            cands = win.gather(1, (j_f[:, :, None] + i_ov).reshape(B, -1))
            corr_f = _corr(cands.reshape(B, len(FINE_REL), OVERLAP), tail,
                           sqp.gather(1, nominal + j_f), sq2)
            corr_f = torch.where(ok, corr_f, -torch.inf)
            best_f, bf = _first_argmax(corr_f)
            off = torch.where(best_f > best, best_off + rel[bf], best_off)
            if searched is not None:
                live = (k < nrun)[:, None]
                n_c = n_c + (valid(nominal, j_c[None, :]) & live).sum()
                n_f = n_f + (ok & live).sum()
        actual = nominal + off
        actual = torch.where(actual + FRAME > ic[:, 0], ic[:, 0] - FRAME,
                             actual)
        new_qo = torch.clamp(actual, min=0) - nominal + MAX_SHIFT
        new_qo = torch.clamp(new_qo, 0, 2 * MAX_SHIFT)  # rows past nrun
        run = k < nrun
        pos[:, k] = torch.where(run, torch.clamp(actual, min=0),
                                -1).to(torch.int32)
        qo = torch.where(run, new_qo, qo)
    if searched is not None:
        searched.update(coarse=int(n_c), fine=int(n_f))
    return pos


def emit_plain(inp, pos, nrun, hop: int, out_size: int):
    """The overlap-add from the chosen positions pos [B, max_steps] i32
    (decide_plain's): frame k < nrun of row b is inp[b, pos[b, k]:][:
    FRAME], Hann-windowed and truncated, added to acc (and the window to
    norm) at k·hop, frames in ascending k from 0.0 — the add sequence of
    the emit kernel. Returns (acc, norm) [B, out_size] f32."""
    B = inp.shape[0]
    dev = inp.device
    acc = torch.zeros(B, out_size, dtype=F32, device=dev)
    norm = torch.zeros(B, out_size, dtype=F32, device=dev)
    K = int(nrun.max()) if B else 0
    if K <= 0:
        return acc, norm
    window = hann(FRAME, dev)
    i_fr = torch.arange(FRAME, device=dev)
    for k in range(K):
        run = (k < nrun)[:, None]
        start = torch.clamp(pos[:, k].to(torch.int64), min=0)
        frame = torch.trunc(inp.gather(1, start[:, None] + i_fr))
        at = slice(k * hop, k * hop + FRAME)
        acc[:, at] = acc[:, at] + torch.where(run, trunc16(frame * window),
                                              0.0)
        norm[:, at] = norm[:, at] + torch.where(run, window, 0.0)
    return acc, norm


def finish(acc, norm, inp, input_count, nrun, speed, out_size: int,
           hop: int):
    """What the JAX package runs after the frame chain
    (ctts_tpu/ops/wsola_jax.py:352, 388-411): one wrap16 of the exact
    sums, division by the window sums where they exceed 0.01, the live
    length of the last frame, the trailing-zero trim, and the
    |speed-1| < 0.01 passthrough. Returns (out [B, out_size] f32,
    out_len [B] i32)."""
    B, S = inp.shape
    dev = inp.device
    speed = torch.clamp(speed.to(F32), 0.5, 2.0)
    passthrough = torch.abs(speed - 1.0) < 0.01
    ic = input_count.to(torch.int64)

    out = wrap16(acc)
    nr = nrun.to(torch.int64)
    actual_len = torch.where(nr > 0, (nr - 1) * hop + FRAME, 0)[:, None]
    good = norm > 0.01
    val = q16(out / torch.where(good, norm, 1.0))
    i = torch.arange(out_size, device=dev)
    live = i < actual_len
    result = torch.where(live & good, val, torch.where(live, out, 0.0))
    nonzero = (result != 0.0) & live
    out_len = torch.where(nonzero.any(1),
                          torch.where(nonzero, i, -1).max(1).values + 1, 0)

    n = min(S, out_size)
    pass_out = F.pad(inp[:, :n], (0, out_size - n))
    pass_out = torch.where(i < ic[:, None], pass_out, 0.0)
    result = torch.where(passthrough[:, None], pass_out, result)
    out_len = torch.where(passthrough, ic, out_len)
    return result, out_len.to(torch.int32)


def time_stretch(inp: torch.Tensor, input_count: torch.Tensor,
                 speed: torch.Tensor, out_size: int, hop: int):
    """Stretch each row inp[b, :input_count[b]] by speed[b]
    (ctts_tpu/ops/wsola_jax.py:212 time_stretch_device, batched).

    inp [B, S] f32 int16-valued, input_count [B] (≤ S), speed [B] f32;
    `hop` = synthesis_hop_for_speed of the bucket's speed and
    `out_size` ≥ num_frames·hop + FRAME + 1024 (plan_arrays._omax_for).
    Returns (out [B, out_size] f32, out_len [B] i32)."""
    # Imported here: ops/hopper/wsola.py imports this module's constants.
    from ctts_tpu_torch.ops.hopper.wsola import wsola_frames

    B, S = inp.shape
    inp = inp.contiguous()
    ic = input_count.to(torch.int32).contiguous()
    nrun = run_counts(ic, S, out_size, hop)
    acc, norm = wsola_frames(inp, energy_table(inp), ic, nrun, hop,
                             out_size)
    return finish(acc, norm, inp, ic, nrun, speed, out_size, hop)
