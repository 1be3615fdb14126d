"""Shared neural layers: norms, RoPE, GQA attention, MLPs, embeddings.

Port of ``repro/arch/layers.py``.  Layers are plain functions on tensors
with parameters as nested dicts, in the reference's layout, so a parameter
tree converts one-to-one (``repro_torch.bridge``).

Kernel routing is an explicit :class:`Dispatch` argument handed down the
call tree, where the reference swaps trace-time override stacks
(``layers.py:89-162``).  Caches are updated **in place**: the reference's
donated ``.at[...].set`` scatters become indexed tensor writes, and the
functions return the same cache dict they were given.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """Which implementation each hot operation runs.

    ``matmul``: "xla" keeps ``torch.matmul`` (where the reference leaves a
    plain ``x @ w`` to XLA); "pallas" routes every projection through the
    hand-written GEMM (``kernels/matmul/ops.py``).  The value names match
    the reference's ``KernelConfig`` so configs stay comparable.
    ``attention``: "flash" routes cached single-token decode through the
    ragged decode-attention kernel; None keeps the masked dense/blockwise
    oracle.  ``decode_block`` pins the contiguous decode KV split (None =
    ``ops._pick_decode_bk``).  ``trace``: the step's ABFT recorder
    (``kernels.abft.AbftTrace``) or None.  With a trace, every projection
    runs through ``trace.mm`` (checksummed; through the checksum GEMM under
    ``matmul="pallas"``) and every paged decode-attention output is
    fingerprinted, where the reference installs ``layers.abft_override``.
    ``q_block``: None, or a prefill whose rows' bits do not depend on the
    admission's shape (how many prompts, how long, or which chunk of a
    longer prompt): attention runs in fixed pieces of ``q_block`` queries
    of one row (``attention.attend``) and ``Model.prefill`` normalizes and
    unembeds each prompt's last row alone.  With an M-invariant GEMM
    (``matmul="pallas"``, or the CPU) a preempted request's re-prefill and
    a chunked prefill then reproduce monolithic admission bit for bit."""

    matmul: str = "xla"
    attention: str | None = None
    decode_block: int | None = None
    q_block: int | None = None
    trace: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.matmul not in ("xla", "pallas"):
            raise ValueError(f"matmul must be 'xla' or 'pallas': {self.matmul!r}")
        if self.attention not in (None, "flash"):
            raise ValueError(
                f"attention must be None or 'flash': {self.attention!r}"
            )
        if self.decode_block is not None and self.decode_block < 1:
            raise ValueError(f"decode block must be >= 1: {self.decode_block!r}")
        if self.q_block is not None and self.q_block < 1:
            raise ValueError(f"q_block must be >= 1: {self.q_block!r}")


PLAIN = Dispatch()


# ------------------------------------------------------------------- norms --


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


# -------------------------------------------------------------------- RoPE --


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions: (...,) int32 -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = theta**exps
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D). cos/sin: (..., T, D//2) broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1).to(x.dtype)


# --------------------------------------------------------------- matmuls --


def _mm(
    x: torch.Tensor, w: torch.Tensor, dispatch: Dispatch, *, trans_b: bool = False
) -> torch.Tensor:
    """``x @ w`` (or ``x @ w.T`` with ``trans_b``) through the dispatched
    GEMM.  The transposed form serves the tied unembedding without copying
    the (vocab, d_model) table."""
    if dispatch.trace is not None:
        return dispatch.trace.mm(x, w, dispatch.matmul, trans_b=trans_b)
    if dispatch.matmul == "pallas":
        from repro_torch.kernels.matmul.ops import matmul

        n = w.shape[0] if trans_b else w.shape[1]
        out = matmul(x.reshape(-1, x.shape[-1]).contiguous(), w, trans_b=trans_b)
        return out.reshape(x.shape[:-1] + (n,))
    return x @ (w.T if trans_b else w)


# --------------------------------------------------------------- attention --


def _normal(shape, std, dtype, generator, device) -> torch.Tensor:
    """Normal(0, std) in ``dtype``, drawn in fp32 one matrix at a time: a
    stack of matrices (layers, experts) never needs an fp32 copy of the
    whole stack (one grok-1 layer's experts are 1.6 G elements)."""
    if len(shape) > 2:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _normal(shape[1:], std, dtype, generator, device)
        return out
    out = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (out * std).to(dtype)


def attention_init(generator, cfg: ModelConfig, device=None, lead=()) -> dict:
    """``lead`` prepends stacked axes (the layer axis) to every weight."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    std, sd = 0.02 / d**0.5, dtype_of(cfg)
    return {
        "wq": _normal(lead + (d, h * hd), std, sd, generator, device),
        "wk": _normal(lead + (d, kv * hd), std, sd, generator, device),
        "wv": _normal(lead + (d, kv * hd), std, sd, generator, device),
        "wo": _normal(lead + (h * hd, d), std, sd, generator, device),
    }


def init_kv_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    window: int | None = None,
    device=None,
) -> dict:
    """Per-layer KV cache; sliding-window layers get a ring of the window
    size.  ``pos``/``len`` are per batch row, so every slot can sit at its
    own sequence position."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    size = max_len if window is None else min(max_len, window)
    sd = dtype_of(cfg)
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=sd, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=sd, device=device),
        # empty slots carry position +1e9 so the causal test masks them
        "pos": torch.full((batch, size), 10**9, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def multihead_attention(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                        # (B, Tq, D)
    *,
    kv_x: torch.Tensor | None = None,       # cross-attention source (B, Tk, D)
    positions: torch.Tensor | None = None,  # absolute q positions (Tq,)
    causal: bool = True,
    window: int | None = None,
    use_rope: bool = True,
    cache: dict | None = None,
    ragged_ok: bool | None = None,
    dispatch: Dispatch = PLAIN,
) -> tuple[torch.Tensor, dict | None]:
    """GQA attention; with ``cache`` given, writes this step's K/V into the
    cache **in place** and attends over it.  Returns (out, cache).

    ``ragged_ok`` asserts the ring invariant the ragged decode path needs
    (every live cache slot lies inside the layer's window).  None derives
    it from ``window`` and the ring size."""
    from repro_torch.arch.attention import attend

    B, Tq, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    src = x if kv_x is None else kv_x
    Tk = src.shape[1]
    dev = x.device

    q = _mm(x, params["wq"], dispatch).reshape(B, Tq, h, hd)
    k = _mm(src, params["wk"], dispatch).reshape(B, Tk, kv, hd)
    v = _mm(src, params["wv"], dispatch).reshape(B, Tk, kv, hd)

    ar = torch.arange(Tq, dtype=torch.int32, device=dev)
    if positions is None:
        # per-row base: rows of a slot cache sit at different positions
        positions = cache["len"][:, None] + ar if cache is not None else ar
    k_pos = positions if kv_x is None else torch.arange(Tk, dtype=torch.int32, device=dev)
    if use_rope:
        qc, qs = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, qc, qs)
        kc, ks_ = rope_angles(k_pos, hd, cfg.rope_theta)
        k = apply_rope(k, kc, ks_)

    g = h // kv
    decode_lengths = None
    if cache is not None and "kpool" in cache:
        # paged slot cache: this token's K/V land at (table[row, pos // bs],
        # pos % bs) of the shared pool.  The engine gives each live row
        # exclusive ownership of that block; evicted rows aim every table
        # entry at the sink block, whose contents nothing live reads.
        if Tq != 1 or kv_x is not None:
            raise ValueError(
                "paged KV caches serve single-token decode only; admission "
                "prefills into a contiguous scratch and packs blocks"
            )
        kpool, vpool, table = cache["kpool"], cache["vpool"], cache["table"]
        bs = kpool.shape[1]
        p_ins = cache["len"].long()
        # a dead row's length keeps growing past its table; its writes go
        # to the sink either way, so clamp the lookup into range
        lb = torch.clamp(p_ins // bs, max=table.shape[1] - 1)
        phys = torch.gather(table, 1, lb[:, None])[:, 0].long()
        kpool[phys, p_ins % bs] = k[:, 0].to(kpool.dtype)
        vpool[phys, p_ins % bs] = v[:, 0].to(vpool.dtype)
        lengths = cache["len"] + 1
        cache["len"].copy_(lengths)
        from repro_torch.kernels.flash_attention.ops import decode_attention_paged

        qg = q.reshape(B, kv, g, hd)
        ctx = decode_attention_paged(
            qg, kpool, vpool, table, lengths,
            # paged caches exist only for all-global configs
            window=None,
            impl=None if dispatch.attention == "flash" else "plain",
        )
        if dispatch.trace is not None:
            ctx = dispatch.trace.check_paged_attention(ctx, qg, kpool, vpool, table, lengths)
        return _mm(ctx.reshape(B, Tq, h * hd), params["wo"], dispatch), cache
    if cache is not None:
        size = cache["k"].shape[1]
        p_ins = positions if positions.ndim == 2 else positions[None, :]
        p_ins = p_ins.expand(B, Tq)
        k_ins, v_ins = k, v
        if Tk > size:  # ring smaller than the insert: keep the last `size`
            k_ins, v_ins, p_ins = k[:, -size:], v[:, -size:], p_ins[:, -size:]
        # ring invariant: slot(pos) = pos % size, independently per row
        slots = (p_ins % size).long()
        rows = torch.arange(B, device=dev)[:, None]
        cache["k"][rows, slots] = k_ins.to(cache["k"].dtype)
        cache["v"][rows, slots] = v_ins.to(cache["v"].dtype)
        cache["pos"][rows, slots] = p_ins.to(torch.int32)
        cache["len"].add_(Tq)
        k, v, k_pos = cache["k"], cache["v"], cache["pos"]
        # ragged flash-decoding: one query per slot attends over live slots
        # [0, min(len, size)), equivalent to the position mask when the
        # ring extent fits the window (see attention.attend)
        if dispatch.attention is not None and Tq == 1 and kv_x is None:
            if ragged_ok is None:
                ragged_ok = window is None or size <= int(window)
            if ragged_ok:
                decode_lengths = torch.clamp(cache["len"], max=size)

    qg = q.reshape(B, Tq, kv, g, hd)
    skip_ok = cfg.causal_skip and kv_x is None and cache is None
    ctx = attend(
        qg, k, v, q_pos=positions, k_pos=k_pos, causal=causal,
        window=window, causal_skip=skip_ok,
        decode_lengths=decode_lengths, decode_impl=dispatch.attention,
        decode_block=dispatch.decode_block, q_block=dispatch.q_block,
    ).reshape(B, Tq, h * hd)
    return _mm(ctx, params["wo"], dispatch), cache


# -------------------------------------------------------------------- MLPs --


def mlp_init(generator, cfg: ModelConfig, device=None, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std, sd = 0.02 / d**0.5, dtype_of(cfg)
    p = {
        "w_in": _normal(lead + (d, f), std, sd, generator, device),
        "w_out": _normal(lead + (f, d), std, sd, generator, device),
    }
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = _normal(lead + (d, f), std, sd, generator, device)
    return p


def mlp(
    params: dict, cfg: ModelConfig, x: torch.Tensor, dispatch: Dispatch = PLAIN
) -> torch.Tensor:
    h = _mm(x, params["w_in"], dispatch)
    if cfg.mlp_act == "swiglu":
        h = torch.nn.functional.silu(_mm(x, params["w_gate"], dispatch)) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return _mm(h, params["w_out"], dispatch)


# -------------------------------------------------------------- embeddings --


def embedding_init(generator, cfg: ModelConfig, device=None) -> dict:
    sd = dtype_of(cfg)
    p = {"tok": _normal((cfg.vocab, cfg.d_model), 0.02, sd, generator, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal((cfg.d_model, cfg.vocab), 0.02, sd, generator, device)
    return p


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def unembed(params: dict, x: torch.Tensor, dispatch: Dispatch = PLAIN) -> torch.Tensor:
    if "unembed" in params:
        return _mm(x, params["unembed"], dispatch)
    return _mm(x, params["tok"], dispatch, trans_b=True)
