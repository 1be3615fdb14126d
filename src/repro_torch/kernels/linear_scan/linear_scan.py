"""The linear-scan kernels: CUDA wrappers and their plain versions.

:func:`linear_scan_cuda` replaces the TPU kernel ``linear_scan_pallas``
(``repro/kernels/linear_scan/linear_scan.py``, the RG-LRU's diagonal
recurrence ``h_t = a_t * h_{t-1} + x_t``) with
``kernels/csrc/linear_scan.cu``: one thread per (batch row, channel),
``h`` in a register for all T, the loads of the next 16 steps issued ahead
of the dependent chain.  It takes fp32 ``(B, T, D)`` tensors whose last
axis is contiguous (any row and step strides) and raises on anything
else.  Each step is one rounded multiply and one rounded add, as in its
plain version :func:`linear_scan_plain` (the reference's step loop,
``ref.linear_scan_ref``), so the two are bitwise equal on the card.  With
``inplace`` the final state overwrites ``h0`` (the serve cache's ``h``).

:func:`wkv6_cuda` replaces the TPU kernel ``wkv6_pallas`` (same file)
with ``kernels/csrc/wkv6.cu``: one block per (batch row, head), each
thread holding one value column of the (Dk, Dv) fp32 state in registers
across all T steps, the sum over the key index in a fixed order.  It takes
fp32 tensors with key and value head sizes Dk and Dv each in
:data:`HEAD_SIZES`, independently, as ``wkv6_pallas`` does, and raises on
anything else.  r, k and w may be any (B, H, T, Dk) views that share one
layout with a contiguous last axis, v any dense (B, H, T, Dv) view with a
contiguous last axis (the model passes its (B, T, H, 64) activations
transposed, with no copy); the output comes back in v's layout.  With
``inplace`` the final state overwrites ``s0`` (the serve cache's state),
which the kernel can do because each block owns its state alone.
:func:`wkv6_plain` is its plain version: the reference's per-step einsum
(``ref.wkv6_ref``).

Each wrapper runs its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan.ref import linear_scan_ref, wkv6_ref

HEAD_SIZES = (16, 32, 64)  # the kernel's Dk and Dv (RWKV-6 heads are 64 wide)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {"wkv6_fp32": [_P] * 8 + [_I] * 5 + [_L] * 6 + [_P]}
_SCAN_SIGS = {"linear_scan_fp32": [_P] * 5 + [_I] * 3 + [_L] * 6 + [_P]}


# ------------------------------------------------------------ diagonal scan


def linear_scan_plain(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    out, hT = linear_scan_ref(a, x, h0)
    if inplace:
        hT = h0.copy_(hT)
    return out, hT


def _check_scan(a, x, h0) -> tuple[int, int, int]:
    """Raise on what the scan kernel does not take; returns (B, T, D)."""
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in (x, h0)):
        raise ValueError("linear_scan needs every operand on one CUDA device: "
                         f"{[str(t.device) for t in (a, x, h0)]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if any(t.dtype != torch.float32 for t in (a, x, h0)):
        raise ValueError(f"kernel takes fp32 operands, got {[t.dtype for t in (a, x, h0)]}")
    if a.ndim != 3 or x.shape != a.shape:
        raise ValueError(f"a and x must be one (B, T, D) shape: {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    B, T, D = a.shape
    if h0.shape != (B, D):
        raise ValueError(f"h0 must be ({B}, {D}): {tuple(h0.shape)}")
    if D > 1 and (a.stride(2) != 1 or x.stride(2) != 1 or h0.stride(1) != 1):
        raise ValueError(f"the channel axis must be contiguous: strides {a.stride()}, "
                         f"{x.stride()}, {h0.stride()}")
    return B, T, D


def linear_scan_cuda(
    a: torch.Tensor,   # (B, T, D) fp32 decay
    x: torch.Tensor,   # (B, T, D) fp32 input
    h0: torch.Tensor,  # (B, D) fp32 state
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, T, D) contiguous, h_T (B, D)); with ``inplace``, h_T is
    ``h0`` updated in place."""
    if all(t.device.type == "cpu" for t in (a, x, h0)):
        return linear_scan_plain(a, x, h0, inplace=inplace)
    B, T, D = _check_scan(a, x, h0)
    out = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    hT = h0 if inplace else torch.empty_like(h0)
    if B * D == 0:
        return out, hT
    lib = _build.library("linear_scan", _SCAN_SIGS)
    err = lib.linear_scan_fp32(
        a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), hT.data_ptr(),
        B, T, D, a.stride(0), a.stride(1), x.stride(0), x.stride(1),
        h0.stride(0), hT.stride(0), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "linear_scan_fp32")
    linear_scan_cuda.launches += 1
    return out, hT


linear_scan_cuda.launches = 0


# ------------------------------------------------------------------- WKV-6


def wkv6_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    out, sT = wkv6_ref(r, k, v, w, u, s0)
    if inplace:
        sT = s0.copy_(sT)
    return out, sT


def _layout(t: torch.Tensor) -> tuple[int, ...]:
    """Strides of the axes that have more than one element: the kernel
    never steps along the others, so their strides do not matter."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape, t.stride()))


def _check(r, k, v, w, u, s0) -> tuple[int, int, int, int, int]:
    """Raise on what the kernel does not take; returns (B, H, T, Dk, Dv)."""
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, w, u, s0)):
        raise ValueError("wkv6 needs every operand on one CUDA device: "
                         f"{[str(t.device) for t in (r, k, v, w, u, s0)]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("kernel takes fp32 operands, got "
                         f"{[t.dtype for t in (r, k, v, w, u, s0)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, w)):
        raise ValueError(f"r, k, w must be one (B, H, T, Dk) shape: "
                         f"{[tuple(t.shape) for t in (r, k, w)]}")
    B, H, T, Dk = r.shape
    if v.ndim != 4 or v.shape[:3] != (B, H, T):
        raise ValueError(f"v must be ({B}, {H}, {T}, Dv): {tuple(v.shape)}")
    Dv = v.shape[3]
    if Dk not in HEAD_SIZES or Dv not in HEAD_SIZES:
        raise ValueError(f"kernel takes key and value head sizes in {HEAD_SIZES}, "
                         f"got Dk={Dk}, Dv={Dv}")
    if r.stride(3) != 1 or any(_layout(t) != _layout(r) for t in (k, w)):
        raise ValueError(f"r, k, w must share strides with a contiguous last axis: "
                         f"{[t.stride() for t in (r, k, w)]}")
    if v.stride(3) != 1:
        raise ValueError(f"v's last axis must be contiguous: strides {v.stride()}")
    if u.shape != (H, Dk) or not u.is_contiguous():
        raise ValueError(f"u must be contiguous ({H}, {Dk}): {tuple(u.shape)}")
    if s0.shape != (B, H, Dk, Dv) or not s0.is_contiguous():
        raise ValueError(f"s0 must be contiguous ({B}, {H}, {Dk}, {Dv}): {tuple(s0.shape)}")
    return B, H, T, Dk, Dv


def wkv6_cuda(
    r: torch.Tensor,   # (B, H, T, Dk) fp32
    k: torch.Tensor,   # (B, H, T, Dk)
    v: torch.Tensor,   # (B, H, T, Dv)
    w: torch.Tensor,   # (B, H, T, Dk) decay in (0, 1)
    u: torch.Tensor,   # (H, Dk) bonus
    s0: torch.Tensor,  # (B, H, Dk, Dv)
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, H, T, Dv) in v's layout, s_T (B, H, Dk, Dv)); with
    ``inplace``, s_T is ``s0`` updated in place."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, s0)):
        return wkv6_plain(r, k, v, w, u, s0, inplace=inplace)
    B, H, T, Dk, Dv = _check(r, k, v, w, u, s0)
    out = torch.empty_like(v)
    if _layout(out) != _layout(v):
        raise ValueError(f"v must be dense (strides {v.stride()})")
    sT = s0 if inplace else torch.empty_like(s0)
    if B * H == 0:
        return out, sT
    lib = _build.library("wkv6", _SIGS)
    err = lib.wkv6_fp32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), sT.data_ptr(), B, H, T, Dk, Dv,
        r.stride(0), r.stride(1), r.stride(2), v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "wkv6_fp32")
    wkv6_cuda.launches += 1
    return out, sT


wkv6_cuda.launches = 0
