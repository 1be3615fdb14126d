"""RWKV-6 (Finch) token mixing; port of ``repro/arch/rwkv.py``.

Per head (key dim Dk, value dim Dv), with state S in R^{Dk x Dv}:

    o_t = r_t . (S_{t-1} + u (x) (k_t v_t^T))
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    w_t = exp(-exp(w0 + tanh(x_w A) B))        (the Finch data-dependent decay)

The recurrence runs in ``kernels.linear_scan.ops.wkv6`` (the CUDA kernel on
the card), over the whole sequence at once: the reference's chunking exists
only to bound its backward pass's memory, and its padded steps (w = 1,
k = v = 0) leave the state as it is.  With a cache the state and the
token-shift row are updated in place.

The reference's numerics are kept: ``mu`` is cast to the model dtype, the
LoRA decay runs in fp32 and ``w`` is rounded through the model dtype before
the fp32 scan, ``u`` and ``ln_scale`` are fp32, the "group norm" is an RMS
over all of D with eps 1e-6, and the projections are plain ``@`` (they do
not follow ``Dispatch.matmul``).
"""

from __future__ import annotations

import torch

from repro_torch.arch.layers import _normal, dtype_of
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan import ops

HEAD_K = 64  # RWKV-6 uses 64-dim heads

LORA_R = 64


def rwkv_head_count(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_K


def rwkv_init(generator, cfg: ModelConfig, device=None, lead=()) -> dict:
    """The reference's distributions; ``lead`` prepends stacked axes (the
    layer axis) to every leaf."""
    d = cfg.d_model
    h = rwkv_head_count(cfg)
    std, sd, f32 = 0.02 / d**0.5, dtype_of(cfg), torch.float32

    def normal(shape, s=std, dtype=sd):
        return _normal(lead + shape, s, dtype, generator, device)

    return {
        # static token-shift lerp coefficients per stream: r, k, v, g, w
        "mu": torch.full(lead + (5, d), 0.5, dtype=f32, device=device),
        "wr": normal((d, d)),
        "wk": normal((d, d)),
        "wv": normal((d, d)),
        "wg": normal((d, d)),
        "w0": torch.full(lead + (d,), -3.0, dtype=f32, device=device),
        "w_lora_a": normal((d, LORA_R)),
        "w_lora_b": torch.zeros(lead + (LORA_R, d), dtype=sd, device=device),
        "u": normal((h, HEAD_K), 0.5, f32),
        "ln_scale": torch.ones(lead + (d,), dtype=f32, device=device),
        "wo": normal((d, d)),
    }


def _streams(params: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift lerp for the five streams; x (B, T, D), x_prev shifted."""
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (x_prev - x) * mu[i] for i in range(5))
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = torch.nn.functional.silu(xg @ params["wg"])
    logw = -torch.exp(
        params["w0"].float()
        + torch.tanh(xw.float() @ params["w_lora_a"].float()) @ params["w_lora_b"].float()
    )
    w = torch.exp(logw)  # in (0, 1)
    return r, k, v, g, w


def wkv_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict | None):
    """The recurrence's operands for ``x`` (B, T, D): r, k, v, w as
    (B, T, H, 64) fp32, u (H, 64) fp32 and the state (the cache's, or
    zeros), plus the gate g (B, T, D)."""
    B, T, D = x.shape
    H = rwkv_head_count(cfg)
    if cache is not None:
        prev_tok = cache["x_prev"][:, None, :]
    else:
        prev_tok = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([prev_tok, x[:, :-1]], dim=1)
    r, k, v, g, w = _streams(params, x, x_prev)
    r, k, v, w = (a.reshape(B, T, H, HEAD_K).float() for a in (r, k, v, w.to(x.dtype)))
    state = (
        cache["state"]
        if cache is not None
        else torch.zeros((B, H, HEAD_K, HEAD_K), dtype=torch.float32, device=x.device)
    )
    return r, k, v, w, params["u"].float(), state, g


def wkv_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, Dk) streams -> (out (B, T, H, Dv), final state), through
    ``ops.wkv6`` on (B, H, T, D) views of the streams (no copies);
    ``inplace`` updates ``state`` itself."""
    out, state = ops.wkv6(
        r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), w.transpose(1, 2),
        u, state, inplace=inplace,
    )
    return out.transpose(1, 2), state


def rwkv_mix(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, T, D)
    cache: dict | None = None,          # {"state": (B,H,Dk,Dv), "x_prev": (B,D)}
) -> tuple[torch.Tensor, dict | None]:
    """Returns (y, cache); the cache's state and ``x_prev`` are updated in
    place."""
    B, T, D = x.shape
    r, k, v, w, u, state, g = wkv_inputs(params, cfg, x, cache)
    out, _ = wkv_scan(r, k, v, w, u, state, inplace=cache is not None)
    o = out.reshape(B, T, D).to(x.dtype)
    # group-norm per head approximated by rms over D, then gate
    of = o.float()
    o = (of * torch.rsqrt(torch.mean(of * of, -1, keepdim=True) + 1e-6)
         * params["ln_scale"]).to(x.dtype)
    y = (o * g) @ params["wo"]
    if cache is not None:
        cache["x_prev"].copy_(x[:, -1])
    return y, cache


def rwkv_init_cache(cfg: ModelConfig, batch: int, device=None, lead=()) -> dict:
    H = rwkv_head_count(cfg)
    return {
        "state": torch.zeros(lead + (batch, H, HEAD_K, HEAD_K), dtype=torch.float32,
                             device=device),
        "x_prev": torch.zeros(lead + (batch, cfg.d_model), dtype=dtype_of(cfg),
                              device=device),
    }
