"""Algorithm-based fault tolerance (ABFT) checks for the serve kernels;
port of ``repro/kernels/abft.py``.

The Huang–Abraham column-checksum identity: for C = A·B,

    e^T · C  ==  (e^T · A) · B        (e = ones)

holds in exact arithmetic, so corrupting one element of C breaks the
equality by exactly the corrupted delta.  The checksum row e^T·A is
appended to A and rides the product GEMM, so the reference side costs one
more output row and no second pass over B.  The tolerance and its
calibration are the reference's, unchanged:

    |e^T·C - (e^T·A)·B|  <=  ATOL + (RTOL + eps(A))·S + eps(C)·(e^T·|C| + |ref|)

with ``S_j = min(max_k|a_k|·colabs_j, sum_k|a_k|·colmax_j)`` from the
static per-column weight stats of :func:`weight_colstats`.

Decode attention has no checksum identity (softmax is nonlinear), so it is
checked by a sampled output fingerprint: :meth:`AbftTrace.check_paged_attention`
recomputes a few rows on the plain version of the paged kernel and compares.

What differs from the reference, and why:

  * The fault operand is a host ``numpy`` int32 vector, not a traced
    operand: eager PyTorch has no compiled program that armed and disarmed
    steps must share.  A disarmed check does no device work at all.
  * The port loops over its layers in Python where the reference scans
    them.  The transformer backbone resets the trace's call counters at
    every layer, so ``mm_calls``/``attn_calls`` count one layer body plus
    the unembed, as the reference's trace-time counters do, and ``layer``
    picks the layer the fault lands in.
  * Through ``torch.matmul`` (``matmul="xla"``) the checksum row runs as its
    own product whatever M is (the reference does so at M == 1 only):
    cuBLAS may round a row differently when a row is appended, and the
    served rows must stay those of an ABFT-off engine.  The hand-written
    GEMM is row-independent (a row's bits do not depend on M), so with
    ``matmul="pallas"`` the row is always appended, M == 1 included.
  * Every verdict stays on the device; the engine moves the step's OR of
    them to the host in the transfer it already makes.
"""

from __future__ import annotations

import numpy as np
import torch

# Calibrated fp32 checksum tolerance (the reference's, property-tested in
# tests/test_sdc.py and tests/test_torch_abft.py).
ABFT_RTOL = 1e-5
ABFT_ATOL = 1e-6

# Fault-operand layout: (site, call_idx, row, col, bit, layer, scrub, 0)
# int32.  `layer` narrows injection to one layer of the backbone (-1 = a
# call outside the layer loop, i.e. the unembed GEMM).  `scrub` (slot 6) is
# no injection field: it asks the step for the full weight-fingerprint
# pass (the host sets it on the ``KernelConfig.scrub_every`` cadence).
FAULT_LEN = 8
FAULT_SCRUB = 6
FAULT_NONE = 0
FAULT_MATMUL = 1       # flip out[row, col] of matmul call #call_idx
FAULT_ATTENTION = 2    # flip ctx[row, col] of attention call #call_idx
FAULT_OUTER = -1       # `layer` value for checks outside the layer loop

# Rows fingerprinted per attention call in "checksum" mode ("paranoid"
# checks every row).
SAMPLE_ROWS = 4


def no_fault() -> np.ndarray:
    """A disarmed fault operand (site FAULT_NONE matches no check site)."""
    return np.zeros((FAULT_LEN,), np.int32)


def sample_rows(batch: int, mode: str, k: int = SAMPLE_ROWS) -> list[int]:
    """Deterministic row sample for the attention fingerprint."""
    if mode == "paranoid" or batch <= k:
        return list(range(batch))
    return [i * batch // k for i in range(k)]


def _leaves(tree) -> list[torch.Tensor]:
    """Tensor leaves of a nested dict in sorted-key order, the order
    ``jax.tree_util.tree_leaves`` visits a dict pytree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def weight_sums(params) -> torch.Tensor:
    """Per-leaf abs-sum fingerprint of a parameter tree, one fp32 value per
    leaf.  Compared *exactly* against a baseline taken at engine init: the
    same reduction on the same tensors gives the same bits.  Checksums
    cannot see weight corruption (both sides of e^T·(A·B) = (e^T·A)·B use
    the corrupted B), so weights get their own detector."""
    return torch.stack(
        [torch.sum(torch.abs(x), dtype=torch.float32) for x in _leaves(params)]
    )


def weight_colstats(params) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Static per-column bounds of every matrix-shaped parameter leaf, for
    the checksum tolerance: ``{"KxN": (colabs, colmax)}`` with
    ``colabs_j = sum_k|w_kj|`` and ``colmax_j = max_k|w_kj|`` (fp32, shape
    (N,)).  Each leaf registers its trailing 2-D slice in both orientations
    (the tied unembedding contracts with ``tok`` transposed); leading axes
    (the layer stack) and same-shaped leaves merge by elementwise max, a
    sound upper bound for whichever slice a call uses."""
    stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def add(key, colabs, colmax):
        if key in stats:
            a0, m0 = stats[key]
            colabs, colmax = torch.maximum(a0, colabs), torch.maximum(m0, colmax)
        stats[key] = (colabs, colmax)

    for x in _leaves(params):
        if x.ndim < 2:
            continue
        K, N = x.shape[-2], x.shape[-1]
        ab = torch.abs(x.reshape(-1, K, N).float())
        add(f"{K}x{N}", ab.sum(1).amax(0), ab.amax(dim=(0, 1)))
        add(f"{N}x{K}", ab.sum(2).amax(0), ab.amax(dim=(0, 2)))
    return stats


def _flip_bit_f32(v: torch.Tensor, bit: int) -> torch.Tensor:
    """Flip one bit of the fp32 representation of ``v``."""
    mask = int(np.uint32(1 << bit).view(np.int32))
    u = v.float().contiguous().view(torch.int32) ^ mask
    return u.view(torch.float32)


def _maybe_flip(a2d: torch.Tensor, fault: np.ndarray, site: int, idx: int, gate: bool):
    """Flip one bit of ``a2d[row % R, col % C]`` **in place** when the fault
    operand targets (site, idx) and the layer gate is open; otherwise leave
    ``a2d`` untouched.  Bits >= 16 survive the round trip through fp32
    exactly for bf16 tensors (bf16 is the top half of fp32).

    ``col == -1`` targets the largest-magnitude element of the row: a
    magnitude-decreasing exponent flip on a tiny element changes the sum by
    less than bf16's own rounding noise, which no checksum can see, so the
    seeded harness aims where detection is owed."""
    if not (int(fault[0]) == site and int(fault[1]) == idx and gate):
        return a2d
    R, C = a2d.shape
    r = int(fault[2]) % R
    if int(fault[3]) < 0:
        c = torch.argmax(torch.abs(a2d[r].float()))
    else:
        c = int(fault[3]) % C
    row = a2d[r]
    row[c] = _flip_bit_f32(row[c], int(fault[4])).to(a2d.dtype)
    return a2d


def _out_eps(dtype: torch.dtype) -> float:
    """Per-element rounding charge for a low-precision product output
    (0 for fp32: its roundoff is covered by the RTOL·scale term)."""
    if dtype == torch.float32:
        return 0.0
    if dtype == torch.bfloat16:
        return 2.0**-8
    return float(torch.finfo(dtype).eps)


def mm_check(x2: torch.Tensor, w: torch.Tensor, out2: torch.Tensor) -> torch.Tensor:
    """Column-checksum verdict for one 2-D product ``out2 = x2 @ w``: a 0-d
    bool tensor, True iff the output's column sums disagree with
    (e^T·x)·w beyond the calibrated tolerance.  The standalone form that
    re-reads ``w``: the calibration tests use it, and :meth:`AbftTrace.mm`
    falls back to it when no static stats cover ``w``."""
    x32, w32, o32 = x2.float(), w.float(), out2.float()
    got = o32.sum(0)
    ref = x32.sum(0) @ w32
    tol = ABFT_ATOL + ABFT_RTOL * (x32.abs().sum(0) @ w32.abs())
    eps = _out_eps(out2.dtype)
    if eps:
        tol = tol + eps * o32.abs().sum(0)
    return torch.any(torch.abs(got - ref) > tol)


def _any(flags: list[torch.Tensor], device) -> torch.Tensor:
    if not flags:
        return torch.zeros((), dtype=torch.bool, device=device)
    return torch.stack(flags).any()


class AbftTrace:
    """Per-step ABFT recorder, handed down the model through
    ``layers.Dispatch.trace``.

    ``mm_calls``/``attn_calls`` number the check sites of one layer body
    plus the unembed (the backbone resets them per layer), so the fault
    operand's ``call_idx`` addresses the same site as the reference's.
    ``flags`` collects one 0-d bool tensor per check; :meth:`drain` ORs and
    clears them per layer, :meth:`any_bad` ORs what is left.

    ``live_splits`` is an optional host-known upper bound on the KV splits
    the fingerprinted rows hold, so the plain recomputation never reads a
    length back from the device (masked splits beyond a row's length add
    exactly nothing)."""

    def __init__(self, mode: str, fault: np.ndarray, colstats=None,
                 live_splits: int | None = None):
        if mode not in ("checksum", "paranoid"):
            raise ValueError(f"abft mode must be 'checksum' or 'paranoid': {mode!r}")
        self.mode = mode
        self.fault = np.asarray(fault, np.int32)
        self.colstats = colstats or {}
        self.live_splits = live_splits
        self.mm_calls = 0
        self.attn_calls = 0
        self.layer: int | None = None
        self.flags: list[torch.Tensor] = []

    def _gate(self) -> bool:
        """Injection gate: the fault's target layer must be the current
        one (or FAULT_OUTER outside the layer loop)."""
        want = FAULT_OUTER if self.layer is None else self.layer
        return int(self.fault[5]) == want

    def drain(self, device=None) -> torch.Tensor:
        """OR-reduce and clear the flags of the current scope."""
        out = _any(self.flags, device)
        self.flags = []
        return out

    # ------------------------------------------------------------ matmul --
    def mm(self, x: torch.Tensor, w: torch.Tensor, impl: str = "xla", *,
           trans_b: bool = False) -> torch.Tensor:
        """Compute, verify and possibly fault-inject one ``x @ w`` (``x @
        w.T`` with ``trans_b``).  ``impl`` "pallas" runs the checksum GEMM
        (its own verdict joins the flags); "xla" runs ``torch.matmul``.
        Returns the product with any injection applied, so a flipped bit
        really corrupts what follows."""
        idx = self.mm_calls
        self.mm_calls += 1
        K = x.shape[-1]
        N = w.shape[0] if trans_b else w.shape[1]
        x2 = x.reshape(-1, K)
        M = x2.shape[0]
        a32 = x2.float().sum(0)
        a = a32.to(x2.dtype)
        if impl == "pallas":
            from repro_torch.kernels.matmul.ops import matmul_abft

            fused, bad = matmul_abft(torch.cat([x2, a[None]]), w, trans_b=trans_b)
            out2, ref = fused[:M], fused[M].float()
            self.flags.append(bad)
        else:
            wl = w.T if trans_b else w
            out2 = x2 @ wl
            ref = (a[None] @ wl)[0].float()
        out2 = _maybe_flip(out2, self.fault, FAULT_MATMUL, idx, self._gate())
        o32 = out2.float()
        got = o32.sum(0)
        key = f"{K}x{N}"
        if key in self.colstats:
            colabs, colmax = self.colstats[key]
            scale = torch.minimum(a32.abs().max() * colabs, a32.abs().sum() * colmax)
            tol = ABFT_ATOL + (ABFT_RTOL + _out_eps(x2.dtype)) * scale
            eps = _out_eps(out2.dtype)
            if eps:
                tol = tol + eps * (o32.abs().sum(0) + ref.abs())
            self.flags.append(torch.any(torch.abs(got - ref) > tol))
        else:
            self.flags.append(mm_check(x2, w.T if trans_b else w, out2))
        return out2.reshape(x.shape[:-1] + (N,))

    # --------------------------------------------------------- attention --
    def check_paged_attention(self, ctx, q, kpool, vpool, tables, lengths):
        """Fingerprint one paged decode-attention output ``ctx`` (shape
        (B, KV, G, d)) by recomputing the sampled rows on the plain version
        of the paged kernel.  Returns ``ctx`` with any injection applied."""
        from repro_torch.kernels.flash_attention.ops import decode_attention_paged

        idx = self.attn_calls
        self.attn_calls += 1
        B = ctx.shape[0]
        c2 = _maybe_flip(ctx.reshape(B, -1), self.fault, FAULT_ATTENTION, idx, self._gate())
        ctx = c2.reshape(ctx.shape)
        rows = torch.tensor(sample_rows(B, self.mode), device=ctx.device)
        ref = decode_attention_paged(
            q[rows], kpool, vpool, tables[rows], lengths[rows], impl="plain",
            n_live=self.live_splits,
        ).float()
        got = ctx[rows].float()
        scale = ref.abs().max()
        self.flags.append(torch.any(torch.abs(got - ref) > ABFT_ATOL + ABFT_RTOL * scale))
        return ctx

    # ------------------------------------------------------------ reduce --
    def any_bad(self, device=None) -> torch.Tensor:
        """0-d bool tensor: did any check of this step fail?"""
        return _any(self.flags, device)
