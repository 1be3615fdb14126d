"""RWKV-6 WKV recurrence: the CUDA kernel wrapper and its plain version.

:func:`wkv6_cuda` replaces the TPU kernel ``wkv6_pallas``
(``repro/kernels/linear_scan/linear_scan.py``) with
``kernels/csrc/wkv6.cu``: one block per (batch row, head), each thread
holding one value column of the 64 x 64 fp32 state in registers across
all T steps, the sum over the key index in a fixed order.  It takes fp32
tensors with head size 64 and raises on anything else.  r, k, v and w may
be any (B, H, T, 64) views that share one dense layout with a contiguous
last axis (the model passes its (B, T, H, 64) activations transposed, with
no copy); the output comes back in that layout.  With ``inplace`` the
final state overwrites ``s0`` (the serve cache's state), which the kernel
can do because each block owns its state alone.

:func:`wkv6_plain` is its plain version: the reference's per-step einsum
(``ref.wkv6_ref``).  The wrapper runs it only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan.ref import wkv6_ref

HEAD_D = 64  # the kernel's head size (RWKV-6 heads are 64 wide)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {"wkv6_fp32": [_P] * 8 + [_I] * 3 + [_L] * 3 + [_P]}


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


def _check(r, k, v, w, u, s0) -> tuple[int, int, int]:
    """Raise on what the kernel does not take; returns (B, H, T)."""
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, w, u, s0)):
        raise ValueError("wkv6 needs every operand on one CUDA device: "
                         f"{[str(t.device) for t in (r, k, v, w, u, s0)]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("kernel takes fp32 operands, got "
                         f"{[t.dtype for t in (r, k, v, w, u, s0)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must be one (B, H, T, D) shape: "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, T, D = r.shape
    if D != HEAD_D:
        raise ValueError(f"kernel takes head size {HEAD_D}, got {D}")
    if r.stride(3) != 1 or any(_layout(t) != _layout(r) for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share strides with a contiguous last axis: "
                         f"{[t.stride() for t in (r, k, v, w)]}")
    if u.shape != (H, D) or not u.is_contiguous():
        raise ValueError(f"u must be contiguous ({H}, {D}): {tuple(u.shape)}")
    if s0.shape != (B, H, D, D) or not s0.is_contiguous():
        raise ValueError(f"s0 must be contiguous ({B}, {H}, {D}, {D}): {tuple(s0.shape)}")
    return B, H, T


def wkv6_cuda(
    r: torch.Tensor,   # (B, H, T, 64) fp32
    k: torch.Tensor,   # (B, H, T, 64)
    v: torch.Tensor,   # (B, H, T, 64)
    w: torch.Tensor,   # (B, H, T, 64) decay in (0, 1)
    u: torch.Tensor,   # (H, 64) bonus
    s0: torch.Tensor,  # (B, H, 64, 64)
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, H, T, 64) in r's layout, s_T (B, H, 64, 64)); with
    ``inplace``, s_T is ``s0`` updated in place."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, s0)):
        return wkv6_plain(r, k, v, w, u, s0, inplace=inplace)
    B, H, T = _check(r, k, v, w, u, s0)
    out = torch.empty_like(v)
    if _layout(out) != _layout(r):
        raise ValueError(f"r, k, v, w must be dense (strides {r.stride()})")
    sT = s0 if inplace else torch.empty_like(s0)
    if B * H == 0:
        return out, sT
    lib = _build.library("wkv6", _SIGS)
    err = lib.wkv6_fp32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), sT.data_ptr(), B, H, T,
        r.stride(0), r.stride(1), r.stride(2), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "wkv6_fp32")
    wkv6_cuda.launches += 1
    return out, sT


wkv6_cuda.launches = 0
