"""Flash attention: the CUDA kernel wrapper and its plain version.

:func:`flash_attention_cuda` replaces the TPU kernel
``flash_attention_pallas`` (``repro/kernels/flash_attention/
flash_attention.py``) with ``kernels/csrc/flash_attention.cu``: causal or
sliding-window GQA attention with an online softmax, one block per (query
head row, query tile) walking the key tiles in order.  q is a
``(B, KV*G, Tq, d)`` view and k, v are ``(B, KV, Tk, d)`` views -- the
reference's flattened ``(B*KV*G, Tq, d)`` / ``(B*KV, Tk, d)`` rows, split
into batch and head so that any strides serve and ``ops.flash_attention``
passes its ``(B, T, KV, G, d)`` arrays without a copy; query head h reads
K/V head ``h // G``.  It takes q, K and V all bf16 or all fp32, head_dim a
multiple of 8 up to 256, and raises on anything else.  The kernel has two
bodies, picked by the dtype alone (:func:`body`): bf16 runs the Hopper
body (a TMA ring feeding ``wgmma`` on two consumer warpgroups, tiles from
:func:`plan`), fp32 the CUDA-core body in full fp32.

Which keys are visited follows the reference, since a query with no live
key gets the mean of the visited V rows (every masked score is the finite
``-1e30``, so each visited key then has p = 1):

* ``kv_len=None`` is the static variant (``_flash_kernel``): the keys
  ``[0, ceil(Tk / bk) * bk)``, the reference's zero-padded last block
  included, live while ``k < Tk``;
* an int ``kv_len`` is the dynamic variant (``_flash_kernel_dyn``): live
  while ``k < kv_len`` (clamped to Tk), and the blocks of ``bk`` keys that
  start below it, which skips the dead ones.

``q_offset`` (the first query's position) and ``kv_len`` are run-time
arguments of the kernel.  :func:`flash_attention_plain` is the plain
version: the reference's online softmax in its block order (blocks of
``bk`` keys, all queries at once), the same ``-1e30``, casts and divide.
The wrapper runs it only for CPU tensors; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # head_dim: a multiple of 8 up to this
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGS = {"flash_attention": [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I] * 6 + [_F, _P],
         "flash_plan": [_I, _P]}

# The bf16 body's budget (csrc/flash_attention.cu): 227 KB of dynamic
# shared memory a block, three warpgroups of 128 threads whose registers
# setmaxnreg moves from the producer (24 a thread) to the two consumers
# (240 each), within the SM's 65,536.
SMEM_LIMIT = 232448
MAX_STAGES = 4
BQ = 128
PRODUCER_REGS, CONSUMER_REGS = 24, 240


@dataclasses.dataclass(frozen=True)
class Plan:
    """The bf16 body's tiles for one head_dim: ``bq`` queries a block (64
    for each consumer warpgroup), ``bkv`` keys a ring stage, ``stages``
    stages of (K, V), ``smem`` dynamic shared bytes."""

    bq: int
    bkv: int
    stages: int
    smem: int


def plan(d: int) -> Plan:
    """The bf16 body's plan for head_dim ``d``, from ``d`` alone (never the
    lengths); ``csrc/flash_attention.cu``'s ``plan`` mirrors it.  Each
    operand tile is ``ceil(d / 64)`` panels of 64 columns (128 bytes a
    row, the 128-byte swizzle); 128 keys a stage while that is at most two
    panels, 64 beyond (d = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB)); as many
    stages as fit, up to 4, beside the Q tile, 1024 bytes of alignment and
    the barriers."""
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}: {d}")
    dp = -(-d // 64)
    bkv = 128 if dp <= 2 else 64
    stage = 2 * dp * bkv * 128
    fixed = dp * BQ * 128 + 1024 + 8 * (2 + 3 * MAX_STAGES)
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    if stages < 2:
        raise ValueError(f"head_dim {d}: the Q tile and two ring stages exceed "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return Plan(BQ, bkv, stages, fixed + stages * stage)


def body(d: int, dtype: torch.dtype) -> str:
    """Which body of the kernel a call runs, by (d, dtype) alone: "tma_wgmma"
    for bf16 (every head_dim the kernel takes; raises on a plan that does
    not fit), "f32_cuda_cores" for fp32."""
    if dtype == torch.bfloat16:
        plan(d)
        return "tma_wgmma"
    if dtype == torch.float32:
        return "f32_cuda_cores"
    raise ValueError(f"kernel takes bf16 or fp32, got {dtype}")


def key_bounds(Tk: int, bk: int, kv_len: int | None) -> tuple[int, int]:
    """(live key bound, visited key bound) of the reference's variant: the
    static one (``kv_len`` None) lives on ``k < Tk`` and visits every block
    of ``bk`` keys, the padded last one included; the dynamic one lives on
    ``k < min(kv_len, Tk)`` and visits the blocks that start below it."""
    if bk < 1:
        raise ValueError(f"bk must be positive: {bk}")
    if kv_len is None:
        return Tk, -(-Tk // bk) * bk
    live = min(int(kv_len), Tk)
    return live, -(-max(live, 0) // bk) * bk


def flash_attention_plain(
    q: torch.Tensor,   # (B, KV*G, Tq, d)
    k: torch.Tensor,   # (B, KV, Tk, d)
    v: torch.Tensor,   # (B, KV, Tk, d)
    *,
    bk: int,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_attention_cuda` -> (B, KV*G, Tq, d)."""
    B, Hq, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = Hq // KV
    live_len, n_visit = key_bounds(Tk, bk, kv_len)
    if n_visit > Tk:  # the reference's zero-padded last block
        k = torch.nn.functional.pad(k, (0, 0, 0, n_visit - Tk))
        v = torch.nn.functional.pad(v, (0, 0, 0, n_visit - Tk))
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, KV, G * Tq, d).float()  # K/V head h serves rows h*G .. h*G+G-1
    q_pos = q_offset + torch.arange(Tq, device=q.device).repeat(G)[:, None]
    m = torch.full((B, KV, G * Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G * Tq, d), dtype=torch.float32, device=q.device)
    for j in range(n_visit // bk):
        kb, vb = k[:, :, j * bk : (j + 1) * bk], v[:, :, j * bk : (j + 1) * bk]
        s = (qg @ kb.float().transpose(-1, -2)) * scale
        k_pos = j * bk + torch.arange(bk, device=q.device)[None, :]
        ok = k_pos < live_len
        if causal:
            ok = ok & (q_pos >= k_pos)
        if window is not None:
            ok = ok & (q_pos - k_pos < window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vb.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(B, Hq, Tq, d)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash attention needs q, k and v on one CUDA device: "
                         f"{q.device}, {k.device}, {v.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes q, k, v all bf16 or all fp32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, KV*G, Tq, d), k and v (B, KV, Tk, d): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Tq, d = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[3] != d or KV < 1 or Hq % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and head_dim "
                         f"must agree and the query heads be a multiple of the KV heads")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim a multiple of 8 up to {MAX_HEAD_DIM}: {d}")
    # TMA reads bf16 rows: every row must start on 16 bytes, and the
    # sequence axis cannot be a broadcast
    align = 16 // q.element_size() if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous: {t.stride()}")
        if any(s % align for s in t.stride()[:3]) or t.data_ptr() % (align * t.element_size()):
            raise ValueError(f"{name}'s rows must start on 16 bytes: strides {t.stride()}")
        if align > 1 and t.shape[2] > 1 and t.stride(2) == 0:
            raise ValueError(f"{name}'s sequence axis must not have stride 0: {t.stride()}")


def flash_attention_cuda(
    q: torch.Tensor,   # (B, KV*G, Tq, d) bf16 or fp32
    k: torch.Tensor,   # (B, KV, Tk, d) q's dtype
    v: torch.Tensor,   # (B, KV, Tk, d) q's dtype
    *,
    bk: int,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """-> (B, KV*G, Tq, d), on the card a view of (B, Tq, KV*G, d) storage
    (the reference's layout).  ``bk`` is the reference's KV block, which
    fixes the visited keys; CPU tensors take the plain version."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, bk=bk, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    _check(q, k, v)
    body(q.shape[3], q.dtype)
    B, Hq, Tq, d = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    live_len, n_visit = key_bounds(Tk, bk, kv_len)
    out = torch.empty((B, Tq, Hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention", _SIGS)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, KV, Tq, Tk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), -1 if window is None else window, int(q_offset), live_len, n_visit,
        int(q.dtype == torch.float32), 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
