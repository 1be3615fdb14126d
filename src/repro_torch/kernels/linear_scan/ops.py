"""Linear-scan entry points; port of ``repro/kernels/linear_scan/ops.py``.
The reference jit-wraps its Pallas calls and interprets them off the TPU;
here each entry point is its kernel's wrapper, which takes the plain
version only for CPU tensors.  The reference's ``bd`` (the TPU's channel
block) has no counterpart: the CUDA scan picks its own channel tiles
(``linear_scan.scan_plan``).

Training differentiates through both entry points, where the reference's
models scan in ``jnp`` and JAX differentiates that scan.  The kernels
write into ``torch.empty`` outputs through raw pointers, which autograd
cannot see, so whenever grad is on and an input requires it the call goes
through a ``torch.autograd.Function``: its forward is the same wrapper
(the kernel on the card, the plain version on the CPU) and its backward

  * for the scan, the reverse-time scan of the adjoint,
    lam_t = a_{t+1} * lam_{t+1} + G_t, run by the same entry point (the
    kernel on the card) on flipped copies; then dx = lam,
    da_t = lam_t * h_{t-1} and dh0 = a_0 * lam_0;
  * for WKV-6, autograd through the plain version ``wkv6_plain``,
    recomputed (the reference has no backward kernel either).

In-place state updates (the serve caches) are refused under autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan.linear_scan import (
    linear_scan_cuda, wkv6_cuda, wkv6_plain,
)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_inplace(name: str, inplace: bool) -> None:
    if inplace:
        raise ValueError(f"{name}: inplace=True cannot be differentiated; "
                         f"an input requires grad")


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, h0):
        out, hT = linear_scan_cuda(a, x, h0)
        ctx.save_for_backward(a, h0, out)
        return out, hT

    @staticmethod
    def backward(ctx, g_out, g_hT):
        a, h0, out = ctx.saved_tensors
        # the adjoint in reversed time s = T-1-t: lam'_s = a'_s lam'_{s-1} +
        # G'_s, with a'_s = a_{T-s} (a'_0 = 0) and G' the flipped output
        # gradient, the final state's added at s = 0
        a_rev = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
        g_rev = g_out.flip(1)
        g_rev[:, 0] += g_hT
        lam_rev, _ = linear_scan_cuda(a_rev, g_rev, torch.zeros_like(h0))
        lam = lam_rev.flip(1)
        da = dh0 = None
        if ctx.needs_input_grad[0]:
            da = lam * torch.cat([h0[:, None], out[:, :-1]], dim=1)
        if ctx.needs_input_grad[2]:
            dh0 = a[:, 0] * lam[:, 0]
        return da, lam, dh0


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return wkv6_cuda(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, g_out, g_sT):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            out, sT = wkv6_plain(*ins)
        grads = iter(torch.autograd.grad((out, sT), wanted, (g_out, g_sT)))
        return tuple(next(grads) if t.requires_grad else None for t in ins)


def linear_scan(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + x_t`` over axis 1 of (B, T, D) fp32 tensors
    from ``h0`` (B, D): returns (out (B, T, D), h_T); ``inplace`` writes
    h_T into ``h0``.  Differentiable (see the module's docstring)."""
    if _needs_grad(a, x, h0):
        _refuse_inplace("linear_scan", inplace)
        return _LinearScan.apply(a, x, h0)
    return linear_scan_cuda(a, x, h0, inplace=inplace)


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence over (B, H, T, D) streams from state ``s0``
    (B, H, D, D): returns (out (B, H, T, D), s_T); ``inplace`` writes s_T
    into ``s0``.  Differentiable (see the module's docstring)."""
    if _needs_grad(r, k, v, w, u, s0):
        _refuse_inplace("wkv6", inplace)
        return _Wkv6.apply(r, k, v, w, u, s0)
    return wkv6_cuda(r, k, v, w, u, s0, inplace=inplace)
