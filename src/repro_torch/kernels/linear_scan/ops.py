"""Linear-scan entry points; port of ``repro/kernels/linear_scan/ops.py``.
The reference jit-wraps its Pallas calls and interprets them off the TPU;
here each entry point is its kernel's wrapper, which takes the plain
version only for CPU tensors.  The reference's ``bd`` (the TPU's channel
block) has no counterpart: the CUDA scan picks its own channel tiles
(``linear_scan.scan_plan``).

Training differentiates through both entry points, where the reference's
models scan in ``jnp`` and JAX differentiates that scan, and a mesh hands
them DTensors.  The kernels write into ``torch.empty`` outputs through raw
pointers, which neither autograd nor DTensor can see, so each recurrence is
a ``torch.library`` custom op (``repro_torch::linear_scan``,
``repro_torch::wkv6``):

  * its forward is the same wrapper (the kernel on the card, the plain
    version on the CPU), called on local tensors;
  * its fake implementation gives the outputs' shapes, so a FakeTensor trace
    (the dry run) never loops over time steps;
  * its backward: for the scan the reverse-time scan of the adjoint,
    lam_t = a_{t+1} * lam_{t+1} + G_t, run by the same op (the kernel on
    the card) on flipped copies, then dx = lam, da_t = lam_t * h_{t-1} and
    dh0 = a_0 * lam_0; for WKV-6 autograd through the plain version
    ``wkv6_plain``, recomputed (the reference has no backward kernel
    either).  On fake tensors WKV-6's backward gives gradients of the right
    shapes without the time loop.

On a mesh each rank runs the op, forward and backward, on its local tensors
(``policy.local_call``, torch's ``local_map``): the scan is independent per
row and per channel, WKV-6 per row and per head, so the streams keep the
rows or the channels (heads) they are split by on each mesh dimension and
are gathered on any other; the time axis is never split.  WKV-6's ``u``
(H, D) is whole where the rows are split, and its gradient there is each
rank's partial sum.

Plain tensors with no gradient to track call the wrapper directly (the
serve path: its in-place state updates included).  Under autograd an
in-place update is refused; on DTensors or fake tensors it is the op's
result copied into the state.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.linear_scan.linear_scan import (
    linear_scan_cuda, wkv6_cuda, wkv6_plain,
)
from repro_torch.parallel.policy import local_call


def _traced(*ts: torch.Tensor) -> bool:
    """True when the op must go through its custom op: a gradient to track,
    a DTensor or a fake tensor among the inputs."""
    return (torch.is_grad_enabled() and any(t.requires_grad for t in ts)) or any(
        isinstance(t, (DTensor, FakeTensor)) for t in ts)


def _refuse_inplace(name: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{name}: inplace=True cannot be differentiated; "
                         f"an input requires grad")


# ------------------------------------------------------------------ scan --


@torch.library.custom_op("repro_torch::linear_scan", mutates_args=())
def _scan_op(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    out, hT = linear_scan_cuda(a, x, h0)
    return out, hT.contiguous()  # both contiguous, as the fake implementation


@_scan_op.register_fake
def _(a, x, h0):
    return a.new_empty(a.shape), h0.new_empty(h0.shape)


def _scan_setup(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, h0, output[0])


def _scan_grads(a, h0, out, g_out, g_hT, needs):
    """The adjoint in reversed time s = T-1-t: lam'_s = a'_s lam'_{s-1} +
    G'_s, with a'_s = a_{T-s} (a'_0 = 0) and G' the flipped output
    gradient, the final state's added at s = 0; run by the scan op itself
    (the kernel on the card)."""
    a_rev = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
    g_rev = torch.cat([(g_out[:, -1] + g_hT)[:, None], g_out[:, :-1].flip(1)], dim=1)
    lam_rev, _ = _scan_op(a_rev, g_rev, torch.zeros_like(h0))
    lam = lam_rev.flip(1)
    da = dh0 = None
    if needs[0]:
        da = lam * torch.cat([h0[:, None], out[:, :-1]], dim=1)
    if needs[2]:
        dh0 = a[:, 0] * lam[:, 0]
    return da, lam, dh0


def _scan_backward(ctx, g_out, g_hT):
    return _scan_grads(*ctx.saved_tensors, g_out, g_hT, ctx.needs_input_grad)


_scan_op.register_autograd(_scan_backward, setup_context=_scan_setup)


# ----------------------------------------------------------------- WKV-6 --


@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def _wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    out, sT = wkv6_cuda(r, k, v, w, u, s0)
    # contiguous, as the fake implementation promises: a DTensor's local
    # tensors must keep the layout its global shape was inferred with (the
    # kernel writes in v's layout, which a rank's local v need not share)
    return out.contiguous(), sT.contiguous()


@_wkv6_op.register_fake
def _(r, k, v, w, u, s0):
    return v.new_empty(v.shape), s0.new_empty(s0.shape)


def _wkv6_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _wkv6_plain_grads(ins, needs, g_out, g_sT):
    """Autograd through the plain version, recomputed, on plain tensors;
    fake tensors (a shape-only trace) get gradients of their shapes without
    the time loop."""
    if isinstance(ins[0], FakeTensor):
        return [t.new_empty(t.shape) if need else None for t, need in zip(ins, needs)]
    ins = [t.detach().requires_grad_(need) for t, need in zip(ins, needs)]
    wanted = [t for t in ins if t.requires_grad]
    with torch.enable_grad():
        out, sT = wkv6_plain(*ins)
    grads = iter(torch.autograd.grad((out, sT), wanted, (g_out, g_sT)))
    return [next(grads).contiguous() if t.requires_grad else None for t in ins]


def _wkv6_backward(ctx, g_out, g_sT):
    return tuple(_wkv6_plain_grads(ctx.saved_tensors, ctx.needs_input_grad, g_out, g_sT))


_wkv6_op.register_autograd(_wkv6_backward, setup_context=_wkv6_setup)


# ------------------------------------------------------------- on a mesh --


def _split(streams, others, keep) -> list:
    """Per mesh dimension, the placement of the first DTensor among
    ``streams`` if it is one of ``keep``, else ``Replicate()``; whole on
    every dimension when only one of ``others`` is a DTensor."""
    first = next((t for t in streams if isinstance(t, DTensor)), None)
    if first is None:
        ndim = next(t for t in others if isinstance(t, DTensor)).device_mesh.ndim
        return [Replicate()] * ndim
    return [p if p in keep else Replicate() for p in first.placements]


def _scan_on_mesh(a, x, h0):
    """The scan on each rank's rows or channels (h0's dimension 1)."""
    stream = _split((a, x), (h0,), (Shard(0), Shard(2)))
    state = [Shard(1) if p == Shard(2) else p for p in stream]
    return local_call(_scan_op, [a, x, h0], [stream, stream, state], (stream, state))


def _wkv6_on_mesh(r, k, v, w, u, s0):
    """WKV-6 on each rank's rows or heads (u's dimension 0)."""
    stream = _split((r, k, v, w), (u, s0), (Shard(0), Shard(1)))
    u_pl = [Shard(0) if p == Shard(1) else Replicate() for p in stream]
    u_grad = [Partial() if p == Shard(0) else q for p, q in zip(stream, u_pl)]
    return local_call(_wkv6_op, [r, k, v, w, u, s0], [stream] * 4 + [u_pl, stream],
                      (stream, stream), [stream] * 4 + [u_grad, stream])


# ----------------------------------------------------------- entry points --


def linear_scan(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + x_t`` over axis 1 of (B, T, D) fp32 tensors
    from ``h0`` (B, D): returns (out (B, T, D), h_T); ``inplace`` writes
    h_T into ``h0``.  Differentiable (see the module's docstring)."""
    if not _traced(a, x, h0):
        return linear_scan_cuda(a, x, h0, inplace=inplace)
    if inplace:
        _refuse_inplace("linear_scan", a, x, h0)
    on_mesh = any(isinstance(t, DTensor) for t in (a, x, h0))
    out, hT = (_scan_on_mesh if on_mesh else _scan_op)(a, x, h0)
    return out, (h0.copy_(hT) if inplace else hT)


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence over (B, H, T, D) streams from state ``s0``
    (B, H, D, D): returns (out (B, H, T, D), s_T); ``inplace`` writes s_T
    into ``s0``.  Differentiable (see the module's docstring)."""
    if not _traced(r, k, v, w, u, s0):
        return wkv6_cuda(r, k, v, w, u, s0, inplace=inplace)
    if inplace:
        _refuse_inplace("wkv6", r, k, v, w, u, s0)
    on_mesh = any(isinstance(t, DTensor) for t in (r, k, v, w, u, s0))
    out, sT = (_wkv6_on_mesh if on_mesh else _wkv6_op)(r, k, v, w, u, s0)
    return out, (s0.copy_(sT) if inplace else sT)
