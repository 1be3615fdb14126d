"""RG-LRU recurrent block (RecurrentGemma / Griffin); port of
``repro/arch/rglru.py``.

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_i x_t) * x_t)

wrapped in the Griffin recurrent block:

    y = GeLU(W_y x)  ;  z = conv1d(W_x x)  ;  z = RG-LRU(z)
    out = W_o (y * z)

The recurrence runs in ``kernels.linear_scan.ops.linear_scan`` (the CUDA
kernel on the card) on ``x_t = sqrt(max(1 - a_t^2, 0)) * gx_t``, computed
before the call, over the whole sequence at once: the reference's chunking
exists only to bound its backward pass's memory, and its padded steps
(a = 1, gx = 0) leave h as it is.  With a cache, ``h`` and the conv
history are updated in place.

The reference's numerics are kept: ``lam`` is an fp32 parameter; the gates
and the scan are fp32 (``zf @ w.float()``, fp32 products: nothing on this
path turns TF32 on); ``y`` is the tanh-approximated GeLU in the model
dtype; the depthwise conv runs in the model dtype in the reference's order;
the projections are plain ``@`` (they do not follow ``Dispatch.matmul``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.arch.layers import _normal, dtype_of
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan import ops

RGLRU_C = 8.0


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def rglru_init(generator, cfg: ModelConfig, device=None, lead=()) -> dict:
    """The reference's distributions (projections normal 0.02/sqrt(d_model),
    the conv kernel normal 0.02, ``lam`` = linspace(0.9, 4.0) in fp32);
    ``lead`` prepends stacked axes to every leaf."""
    d, w = cfg.d_model, rglru_width(cfg)
    std, sd = 0.02 / d**0.5, dtype_of(cfg)

    def normal(shape, s=std):
        return _normal(lead + shape, s, sd, generator, device)

    lam = torch.linspace(0.9, 4.0, w, dtype=torch.float32, device=device)
    return {
        "w_y": normal((d, w)),
        "w_x": normal((d, w)),
        "conv": normal((cfg.conv1d_width, w), 0.02),
        "w_a": normal((w, w)),
        "w_i": normal((w, w)),
        # Lambda init so that a^c spans (0.9, 0.999), Griffin appendix
        "lam": lam.expand(lead + (w,)).clone(),
        "w_o": normal((w, d)),
    }


def _causal_conv1d(
    z: torch.Tensor, kernel: torch.Tensor, prev: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. z: (B, T, W), kernel: (K, W), prev: (B, K-1, W)
    history for decode; returns (out, new history)."""
    B, T, Wd = z.shape
    K = kernel.shape[0]
    if prev is None:
        prev = torch.zeros((B, K - 1, Wd), dtype=z.dtype, device=z.device)
    zp = torch.cat([prev, z], dim=1)
    out = torch.zeros_like(z)
    for i in range(K):
        out = out + zp[:, i : i + T] * kernel[K - 1 - i]
    return out, zp[:, -(K - 1):]


def rglru_scan(
    a: torch.Tensor, gx: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*gx_t ; a, gx: (B, T, W) fp32, h0
    (B, W).  ``inplace`` writes the final h into ``h0``."""
    x = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * gx
    return ops.linear_scan(a, x, h0, inplace=inplace)


def rglru_block(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                # (B, T, D)
    cache: dict | None = None,      # {"h": (B, W) fp32, "conv": (B, K-1, W)}
) -> tuple[torch.Tensor, dict | None]:
    """Returns (y, cache); the cache's ``h`` and ``conv`` are updated in
    place."""
    B = x.shape[0]
    y = F.gelu(x @ params["w_y"], approximate="tanh")
    z = x @ params["w_x"]
    z, conv_hist = _causal_conv1d(
        z, params["conv"], cache["conv"] if cache is not None else None
    )
    zf = z.float()
    log_a = (-RGLRU_C * F.softplus(params["lam"])) * torch.sigmoid(
        zf @ params["w_a"].float()
    )
    a = torch.exp(log_a)
    gate_in = torch.sigmoid(zf @ params["w_i"].float()) * zf
    h0 = (
        cache["h"]
        if cache is not None
        else torch.zeros((B, a.shape[-1]), dtype=torch.float32, device=x.device)
    )
    out, _ = rglru_scan(a, gate_in, h0, inplace=cache is not None)
    res = (out.to(x.dtype) * y) @ params["w_o"]
    if cache is not None:
        cache["conv"].copy_(conv_hist)
    return res, cache


def rglru_init_cache(cfg: ModelConfig, batch: int, device=None, lead=()) -> dict:
    w = rglru_width(cfg)
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, w), dtype=dtype_of(cfg),
                            device=device),
    }
