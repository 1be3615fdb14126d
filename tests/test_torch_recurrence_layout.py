"""A numpy model of the two recurrence kernels (``csrc/linear_scan.cu``
and ``csrc/wkv6.cu``) on the CPU, and their plans.

The kernels cannot run here, so their index arithmetic is rehearsed: the
model follows each kernel's own formulas, with each hardware unit reduced
to what the kernel assumes of it:

- the scan's step body: thread ``x * 128 + t`` of block row b owns
  channels ``(x * 128 + t) * V`` onward of row b (V = 4 or 1); the ring body: block
  (x, b) owns channels ``32 x`` to ``32 x + 31`` of row b, stage ``st``
  (steps ``S st`` to ``S st + S - 1``, S = 64 or 128) lands in slot ``st %
  stages`` as a TMA
  box (zeros outside the tensor) or as one 4-byte copy a lane and step,
  the slot's barrier completing once per fill (the wait's parity is
  ``(st // stages) & 1``), and a slot is refilled with stage ``st +
  stages`` right after the chain has left stage ``st``;
- WKV-6: block (cb, h, b) owns value columns ``cols cb`` onward of (b, h)
  (cols = 16, or 32 below 16 steps where Dv allows); thread ``(cols / 4) g
  + q`` the state of key rows ``2 g, 2 g + 1`` and columns ``4 q`` to ``4 q
  + 3`` of them; a chunk of up to 16 steps is copied as ``n (3 Dk / V +
  cols / V)`` vectors, vector ``e`` of step ``e // (3 Dk / V + cols / V)``;
  the reduction's item ``e`` is output ``(e // cols, e % cols)`` of the
  chunk; a one-step call reads its operands without the ring.  Per element and step ``kv = k v``, ``term =
  fma(u, kv, S)``, the partial ``r term`` (row 2 g) then ``fma(r, term,
  partial)`` (row 2 g + 1), ``S = fma(w, S, kv)``; an output adds its
  partials as a pairwise tree over g.  A fused multiply-add is taken in
  float64 and rounded once to float32 (the float64 product of two float32
  values is exact).

The scan's model must equal ``linear_scan_plain`` bit for bit.  WKV-6's
model must give the same bits for a row whatever B, H and column split
the call has, and lie within the reference test's 2e-4 of
``repro.kernels.linear_scan.ref.wkv6_ref`` and of the reference's
``ops.wkv6`` in interpret mode.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.linear_scan import ops as jops  # noqa: E402
from repro.kernels.linear_scan.ref import wkv6_ref as jref  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan as ls  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's tests/test_kernels.py


# ------------------------------------------------------------------ scan --


def scan_inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((B, T, D), dtype=np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, x, h0


def step(a, h, x):
    """One step as the kernel takes it: __fmul_rn, then __fadd_rn."""
    return np.float32(np.float32(a * h) + x)


def model_scan(a, x, h0, plan):
    """The scan kernel's walk under ``plan``: -> (out, hT, how often each
    output element and each final state was written)."""
    B, T, D = a.shape
    out = np.full((B, T, D), np.nan, np.float32)
    hT = np.full((B, D), np.nan, np.float32)
    writes, finals = np.zeros((B, T, D), int), np.zeros((B, D), int)
    if plan.body.startswith("step"):
        V = 4 if plan.body == "step4" else 1
        assert plan.grid[1] == B and plan.grid[0] * plan.threads * V >= D
        for b, tid in np.ndindex(B, plan.grid[0] * plan.threads):
            d = tid * V
            if d >= D:
                continue
            lanes = slice(d, d + V)
            h = h0[b, lanes].copy()
            for t in range(T):
                h = step(a[b, t, lanes], h, x[b, t, lanes])
                out[b, t, lanes] = h
                writes[b, t, lanes] += 1
            hT[b, lanes] = h
            finals[b, lanes] += 1
        return out, hT, writes, finals
    S, CT, slots = plan.steps, ls.SCAN_CT, plan.stages
    nst = -(-T // S)
    assert plan.grid == (-(-D // CT), B) and plan.threads == 32
    for bx in range(plan.grid[0]):
        for b in range(B):
            d0 = bx * CT
            ring = np.zeros((slots, 2, S, CT), np.float32)
            held = [-1] * slots       # the stage each slot holds
            fills = [0] * slots       # completed phases of each slot's barrier

            def issue(st):
                slot = st % slots
                t, d = np.indices((S, CT))
                t, d = t + st * S, d + d0
                inside = (t < T) & (d < D)
                tc, dc = np.minimum(t, T - 1), np.minimum(d, D - 1)
                # a TMA box and the lanes' zero-filled 4-byte copies write
                # the same values: the element, or 0 outside the tensor
                ring[slot, 0] = np.where(inside, a[b, tc, dc], 0)
                ring[slot, 1] = np.where(inside, x[b, tc, dc], 0)
                held[slot] = st
                fills[slot] += 1

            for st in range(min(slots, nst)):
                issue(st)
            lanes = np.arange(CT)
            live = d0 + lanes < D
            h = np.where(live, h0[b, np.minimum(d0 + lanes, D - 1)], 0).astype(np.float32)
            for st in range(nst):
                slot = st % slots
                # the wait's parity is that of the slot's latest phase
                assert held[slot] == st and (fills[slot] - 1) & 1 == (st // slots) & 1
                for i in range(min(S, T - st * S)):
                    h = step(ring[slot, 0, i], h, ring[slot, 1, i])
                    t = st * S + i
                    out[b, t, d0 + lanes[live]] = h[live]
                    writes[b, t, d0 + lanes[live]] += 1
                if st + slots < nst:
                    issue(st + slots)
            hT[b, d0 + lanes[live]] = h[live]
            finals[b, d0 + lanes[live]] += 1
    return out, hT, writes, finals


@pytest.mark.parametrize("B,T,D", [
    (8, 1, 2560 // 8), (3, 8, 100), (2, 9, 100), (1, 37, 100), (2, 64, 64), (1, 65, 40),
    (1, 129, 40), (1, 300, 96), (2, 0, 12), (1, 5, 1), (1, 40, 1), (1, 70, 12),
])
@pytest.mark.parametrize("vec", [True, False])
def test_scan_model_covers_every_element_once_and_equals_plain(B, T, D, vec):
    """Both sides of the step body's threshold (8) and of the ring's switch
    from 64-step to 128-step stages (65), T not a multiple of a stage, D
    not a multiple of the 32-channel tile (or below it), D = 1, each body
    with and without vectors / TMA."""
    a, x, h0 = scan_inputs(B, T, D, seed=B * 1000 + T * 10 + D)
    plan = ls.scan_plan(B, T, D, vec and D % 4 == 0, vec)
    out, hT, writes, finals = model_scan(a, x, h0, plan)
    assert (writes == 1).all() and (finals == 1).all()
    want_out, want_h = ls.linear_scan_plain(*map(torch.from_numpy, (a, x, h0)))
    assert np.array_equal(out, want_out.numpy()) and np.array_equal(hT, want_h.numpy())


@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_scan_model_at_decays_zero_and_one(fill):
    B, T, D = 2, 70, 40
    _, x, h0 = scan_inputs(B, T, D, seed=5)
    a = np.full((B, T, D), fill, np.float32)
    plan = ls.scan_plan(B, T, D, True, True)
    assert plan.body == "ring_tma"
    out, hT, _, _ = model_scan(a, x, h0, plan)
    want_out, want_h = ls.linear_scan_plain(*map(torch.from_numpy, (a, x, h0)))
    assert np.array_equal(out, want_out.numpy()) and np.array_equal(hT, want_h.numpy())


def test_scan_eligibility_follows_bases_and_strides():
    """16-byte vectors and TMA only where every base and stride the body
    reads is a multiple of 16 bytes; a broadcast step axis has no map."""
    big = torch.zeros(16384)
    base = big[(-big.data_ptr() // 4) % 4:]  # a 16-byte aligned start
    a = base[: 2 * 40 * 96].view(2, 40, 96)
    h0 = torch.zeros(2, 96)
    assert ls.scan_eligibility(a, a, h0, torch.empty(2, 40, 96), h0) == (True, True)
    off = base[50: 50 + 2 * 40 * 96].view(2, 40, 96)  # 200 bytes in: misaligned
    assert ls.scan_eligibility(a, off, h0, torch.empty(2, 40, 96), h0) == (False, False)
    odd = base[: 2 * 40 * 98].view(2, 40, 98)[..., :96]  # steps 392 bytes apart
    assert ls.scan_eligibility(odd, a, h0, torch.empty(2, 40, 96), h0) == (False, False)
    bcast = base[:96].expand(2, 40, 96)  # the same a at every step and row
    assert ls.scan_eligibility(bcast, a, h0, torch.empty(2, 40, 96), h0) == (True, False)
    assert ls.scan_plan(2, 40, 96, True, False).body == "ring_copy"
    assert ls.scan_plan(2, 40, 96, True, True).steps == 64
    assert ls.scan_plan(2, 64, 96, True, True).steps == 64
    assert ls.scan_plan(2, 65, 96, True, True).steps == 128
    assert ls.scan_plan(2, 8, 98, False, False).body == "step1"


# ----------------------------------------------------------------- WKV-6 --


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def wkv_inputs(B, H, T, Dk, Dv, seed, w=None):
    """As the reference's tests draw them (``tests/test_torch_wkv6.py``)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, H, T, Dk)).astype(np.float32) for _ in "rk")
    v = rng.standard_normal((B, H, T, Dv)).astype(np.float32)
    if w is None:
        w = np.exp(-np.exp(rng.normal(-1.0, 1.0, (B, H, T, Dk)))).astype(np.float32)
    else:
        w = np.full((B, H, T, Dk), w, np.float32)
    u = rng.standard_normal((H, Dk)).astype(np.float32)
    s0 = rng.standard_normal((B, H, Dk, Dv)).astype(np.float32)
    return r, k, v, w, u, s0


def block_step(s, r, k, v, w, u):
    """One step of one block: ``s`` (Dk, cols) the block's state, r, k, w,
    u (Dk,), v (cols,) -> (its Dk / 2 partials of each column, the new
    state), row 2 g's term first in partial g."""
    kv = np.float32(k[:, None] * v[None, :])
    term = fma(u[:, None], kv, s)
    part = np.float32(r[0::2, None] * term[0::2])
    part = fma(r[1::2, None], term[1::2], part)
    return part, fma(w[:, None], s, kv)


def reduce_partials(part):
    """An output's partials (axis 0) added as ``tree_sum`` adds them: a
    pairwise tree, (p0 + p1), (p2 + p3), ..., then pairs of those."""
    x = list(part)
    w = 1
    while w < len(x):
        for i in range(0, len(x) - w, 2 * w):
            x[i] = np.float32(x[i] + x[i + w])
        w *= 2
    return x[0]


def model_wkv(r, k, v, w, u, s0, vec=True, cover=None):
    """The WKV-6 kernel's walk under its plan: the grid (Dv / cols, H, B),
    every block's chunks and ring slots (or, for one step, its operands read
    straight from the streams), its per-step partials and its per-chunk
    reduction.  ``cover`` (optional dict) counts the state elements, stream
    floats and outputs each block touches."""
    B, H, T, Dk = r.shape
    Dv = v.shape[3]
    plan = ls.wkv_plan(B, H, T, Dk, Dv, vec)
    V, C, NT, CB = plan.vec, plan.chunk, plan.threads, plan.cols
    KV, CV = Dk // V, CB // V
    ncb = Dv // CB
    assert plan.grid == ncb * H * B
    # thread (cols / 4) g + q owns rows 2g, 2g+1 x columns 4q..4q+3
    rows, width = 2, 4
    assert NT == Dk // rows * (CB // width)
    out = np.full((B, H, T, Dv), np.nan, np.float32)
    sT = np.full_like(s0, np.nan)
    for b, h, cb in np.ndindex(B, H, ncb):
        cols = slice(cb * CB, (cb + 1) * CB)
        if cover is not None:
            for tid in range(NT):
                g, q = divmod(tid, CB // width)
                for rr in range(rows):
                    for e in range(width):
                        cover["state"][b, h, rows * g + rr, cb * CB + width * q + e] += 1
        s = s0[b, h, :, cols].copy()
        if T == 1:  # one step: the operands without the ring
            part, s = block_step(s, r[b, h, 0], k[b, h, 0], v[b, h, 0, cols], w[b, h, 0], u[h])
            out[b, h, 0, cols] = reduce_partials(part)
            if cover is not None:
                cover["streams"][:, b, h, 0] += 1
                cover["v"][b, h, 0, cols] += 1
                cover["out"][b, h, 0, cols] += 1
            sT[b, h, :, cols] = s
            continue
        ring = np.zeros((ls.WKV_STAGES, C, ls.wkv_row_floats(Dk, CB)), np.float32)
        nch = -(-T // C)
        for c in range(nch):
            slot, t0 = c % ls.WKV_STAGES, c * C
            n = min(C, T - t0)
            for e in range(n * (3 * KV + CV)):  # the copies, any thread
                t, f = divmod(e, 3 * KV + CV)
                if f < 3 * KV:
                    which, i = f // KV, (f % KV) * V
                    src = (r, k, w)[which][b, h, t0 + t, i:i + V]
                    ring[slot, t, which * Dk + i: which * Dk + i + V] = src
                    if cover is not None:
                        cover["streams"][which, b, h, t0 + t, i:i + V] += 1
                else:
                    j = (f - 3 * KV) * V
                    ring[slot, t, 3 * Dk + j: 3 * Dk + j + V] = \
                        v[b, h, t0 + t, cb * CB + j: cb * CB + j + V]
                    if cover is not None:
                        cover["v"][b, h, t0 + t, cb * CB + j: cb * CB + j + V] += 1
            parts = np.zeros((n, Dk // 2, CB), np.float32)
            for t in range(n):
                row = ring[slot, t]
                parts[t], s = block_step(s, row[:Dk], row[Dk:2 * Dk], row[3 * Dk:],
                                         row[2 * Dk:3 * Dk], u[h])
            for e in range(n * CB):  # the reduction, any thread
                t, j = divmod(e, CB)
                out[b, h, t0 + t, cb * CB + j] = reduce_partials(parts[t, :, j:j + 1])[0]
                if cover is not None:
                    cover["out"][b, h, t0 + t, cb * CB + j] += 1
        sT[b, h, :, cols] = s
    return out, sT


def model_wkv_whole(r, k, v, w, u, s0):
    """The same arithmetic on every (b, h, column) at once, with no block,
    chunk or ring: the order of the sums decides the bits, not the grid."""
    B, H, T, Dk = r.shape
    s = s0.copy()
    out = np.empty(v.shape, np.float32)
    for t in range(T):
        kv = np.float32(k[:, :, t, :, None] * v[:, :, t, None, :])
        term = fma(u[None, :, :, None], kv, s)
        rt = r[:, :, t, :, None]
        part = np.float32(rt[:, :, 0::2] * term[:, :, 0::2])
        part = fma(rt[:, :, 1::2], term[:, :, 1::2], part)
        out[:, :, t] = reduce_partials(np.moveaxis(part, 2, 0))
        s = fma(w[:, :, t, :, None], s, kv)
    return out, s


@pytest.mark.parametrize("Dk,Dv", [(16, 16), (32, 64), (64, 16), (64, 64), (16, 32)])
@pytest.mark.parametrize("T", [1, 16, 37])
def test_wkv_model_covers_every_element_once(Dk, Dv, T):
    B, H = 2, 3
    args = wkv_inputs(B, H, T, Dk, Dv, seed=Dk + Dv + T)
    cover = dict(state=np.zeros((B, H, Dk, Dv), int), out=np.zeros((B, H, T, Dv), int),
                 streams=np.zeros((3, B, H, T, Dk), int), v=np.zeros((B, H, T, Dv), int))
    out, sT = model_wkv(*args, cover=cover)
    ncb = Dv // ls.wkv_plan(B, H, T, Dk, Dv, True).cols
    assert (cover["state"] == 1).all() and (cover["out"] == 1).all()
    assert (cover["v"] == 1).all() and (cover["streams"] == ncb).all()  # r, k, w once a block
    whole = model_wkv_whole(*args)
    assert np.array_equal(out, whole[0]) and np.array_equal(sT, whole[1])


@pytest.mark.parametrize("Dk,Dv", [(64, 64), (16, 16), (32, 64)])
def test_wkv_order_of_sums_depends_on_dk_alone(Dk, Dv):
    """A row's bits are the same alone, in a batch of other B and H, and
    with 4-byte or 16-byte copies; the block model equals the whole-array
    model, which has no grid at all."""
    B, H, T = 3, 4, 21
    args = wkv_inputs(B, H, T, Dk, Dv, seed=Dk * 3 + Dv)
    full = model_wkv(*args)
    b, h = 2, 1
    solo_args = [t[b:b + 1, h:h + 1] for t in args[:4]] + [args[4][h:h + 1],
                                                           args[5][b:b + 1, h:h + 1]]
    solo = model_wkv(*solo_args, vec=False)
    assert np.array_equal(solo[0][0, 0], full[0][b, h])
    assert np.array_equal(solo[1][0, 0], full[1][b, h])
    sub = model_wkv(*[t[:2] for t in args[:4]], args[4], args[5][:2])
    assert np.array_equal(sub[0], full[0][:2]) and np.array_equal(sub[1], full[1][:2])
    whole = model_wkv_whole(*args)
    assert np.array_equal(full[0], whole[0]) and np.array_equal(full[1], whole[1])


@pytest.mark.parametrize("B,H,T,Dk,Dv", [(1, 1, 8, 16, 16), (2, 3, 17, 32, 64),
                                         (1, 2, 40, 64, 64), (2, 2, 5, 64, 16)])
def test_wkv_model_matches_the_reference(B, H, T, Dk, Dv):
    args = wkv_inputs(B, H, T, Dk, Dv, seed=B * 100 + T + Dk)
    out, sT = model_wkv_whole(*args)
    j_out, j_s = jops.wkv6(*map(jnp.asarray, args), interpret=True)
    r_out, r_s = jref(*map(jnp.asarray, args))
    for want_out, want_s in ((j_out, j_s), (r_out, r_s)):
        np.testing.assert_allclose(out, np.asarray(want_out), **TOL)
        np.testing.assert_allclose(sT, np.asarray(want_s), **TOL)


@pytest.mark.parametrize("decay", [0.0, 1.0, 1e-30])
def test_wkv_model_at_extreme_decays(decay):
    """w = 0 (forget at once), w = 1 (never forget) and w ~ 1e-30 (products
    below fp32's normal range), against the port's plain version within
    1e-5 of the scale, as the card test holds the kernel."""
    args = wkv_inputs(2, 2, 33, 64, 64, seed=3, w=decay)
    out, sT = model_wkv_whole(*args)
    want = ls.wkv6_plain(*map(torch.from_numpy, args))
    for got, ref in zip((out, sT), want):
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# ----------------------------------------------------------------- plans --


def test_plans_at_the_serve_shapes_fit_and_fill_the_card():
    """The scan: decode (8, 1, 2560) on the step body, 40 blocks all
    resident; prefill (1, 2048, 2560) on the TMA ring, 80 blocks resident
    at once, each with 3 stages of 128 steps, ~8 MB in flight.  WKV-6:
    decode (8, 32, 1, 64, 64) 512 blocks of 32 columns in one wave; prefill
    (1, 32, 256) 128 blocks of 16 columns and 4 warps, one an SM, every
    block's ring within 227 KB."""
    dec = ls.scan_plan(8, 1, 2560, True, True)
    assert dec.body == "step4" and dec.grid == (5, 8)
    assert ls.resident_blocks(40, dec.threads, dec.smem) == 40
    pre = ls.scan_plan(1, 2048, 2560, True, True)
    assert pre.body == "ring_tma" and pre.grid == (80, 1) and (pre.steps, pre.stages) == (128, 3)
    assert pre.smem <= hw.SMEM_PER_BLOCK_BYTES
    assert ls.resident_blocks(80, pre.threads, pre.smem) == 80
    assert pre.in_flight(1, 2048, 2560) >= 4e6
    wdec = ls.wkv_plan(8, 32, 1, 64, 64, True)
    assert (wdec.cols, wdec.grid, wdec.threads, wdec.chunk, wdec.unroll) == (32, 512, 256, 1, 1)
    # the one-step instance's 64 registers a thread leave room for 4 blocks
    # of 256 threads an SM: one wave; at 80 registers (3 an SM) it would
    # take two
    assert ls.resident_blocks(wdec.grid, wdec.threads, wdec.smem, wdec.max_regs) == 512
    assert ls.resident_blocks(wdec.grid, wdec.threads, wdec.smem, 80) < 512
    wpre = ls.wkv_plan(1, 32, 256, 64, 64, True)
    assert (wpre.cols, wpre.grid, wpre.threads, wpre.chunk, wpre.unroll) == (16, 128, 128, 16, 4)
    assert wpre.smem <= hw.SMEM_PER_BLOCK_BYTES and wpre.grid <= hw.SM_COUNT
    for Dk in ls.HEAD_SIZES:
        assert ls.wkv_plan(8, 32, 4096, Dk, 64, False).smem <= hw.SMEM_PER_BLOCK_BYTES


@pytest.mark.parametrize("B,T,D", [(8, 1, 2560), (1, 2048, 2560), (3, 37, 100), (1, 9, 1)])
def test_scan_plan_is_keyed_on_shape_and_eligibility_only(B, T, D):
    p = ls.scan_plan(B, T, D, True, True)
    assert p.as_ints()[0] == ls.SCAN_BODIES.index(p.body)
    assert p.threads * p.grid[0] * p.grid[1] >= B * D // (4 if p.body == "step4" else 1)
    if p.body.startswith("ring"):
        assert p.stages == min(ls.SCAN_RING_BYTES // ls.scan_stage_bytes(p.steps), -(-T // p.steps))
        assert p.smem <= ls.SCAN_RING_BYTES + 64
