"""Mixture-of-Experts: top-k router and capacity-bounded dispatch; port of
``repro/arch/moe.py``.

Routing is per row (sequence), as in the reference: each row's ``S * K``
assignments sort by expert (stable), take a rank within their expert, and
the first ``C = max(1, ceil(S * K * capacity_factor / E))`` of each expert
fill its ``C`` slots; the rest are dropped (Switch-style).  The stacked
expert FFN runs as one batched product over ``(B, E, C, D)``, outside any
kernel, as the reference's einsum does.

Two of the reference's scatters are written as gathers here, so that no
result depends on which of several colliding writes lands first:

  * **dispatch**: the reference scatters every assignment to slot
    ``e * C + min(rank, C - 1)``, dropped ones as zeros, so an expert that
    overflows receives its kept rank-``C - 1`` token and then zeros in the
    same slot; on the CPU the last write wins and that slot holds zero
    (while the token's gate weight still counts at the combine).  The port
    fills each slot from its rank's token and zeroes slot ``C - 1`` of
    every expert that overflows: the reference's CPU result, spelled out.
  * **combine**: the reference scatter-adds each assignment's weighted
    output into its token.  The port gathers every token's ``K`` outputs
    and sums them one after another in ascending expert order (the order
    of the reference's sorted scatter), with no atomics, so a repeat is
    bitwise and a row's result does not depend on the other rows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.arch import layers as L
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.policy import experts_local, gather_rows, shard


def moe_init(generator, cfg: ModelConfig, device=None, lead=()) -> dict:
    """The router in fp32, normal 0.02; the experts' ``(E, D, F)`` and
    ``(E, F, D)`` weights normal 0.02/sqrt(d) in the model's dtype.
    ``lead`` prepends stacked axes (the layer axis)."""
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    std, sd = 0.02 / math.sqrt(d), L.dtype_of(cfg)
    p = {
        "router": L._normal(lead + (d, e), 0.02, torch.float32, generator, device),
        "w_in": L._normal(lead + (e, d, f), std, sd, generator, device),
        "w_out": L._normal(lead + (e, f, d), std, sd, generator, device),
    }
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = L._normal(lead + (e, d, f), std, sd, generator, device)
    return p


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert and row for a row of ``seq_len`` tokens."""
    m = cfg.moe
    return max(1, int(math.ceil(seq_len * m.top_k * m.capacity_factor / m.num_experts)))


def route(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """(probs (B, S, E), normalized gates (B, S, K), expert ids (B, S, K))
    in fp32.  Top-k by a stable descending sort: ties go to the lower
    expert id, as ``jax.lax.top_k`` breaks them."""
    K = cfg.moe.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[..., :K], ids[..., :K]
    return probs, gate / gate.sum(dim=-1, keepdim=True), ids


def aux_loss(probs: torch.Tensor, ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The Switch load-balancing loss, E * sum_e(mean prob_e * load_e)."""
    K = ids.shape[-1]
    me = probs.mean(dim=(0, 1))
    load = torch.nn.functional.one_hot(ids.long(), num_experts).float().sum(dim=2)
    ce = load.mean(dim=(0, 1)) / K
    return num_experts * torch.sum(me * ce)


def _filled(counts: torch.Tensor, C: int) -> torch.Tensor:
    """(B, E, C) mask of the dispatch slots that hold a token: slot c of
    expert e when c < min(count_e, C), except slot C - 1 of an expert that
    overflows (count_e > C), where the reference's dropped zeros land
    after its kept token."""
    c_ar = torch.arange(C, device=counts.device)
    return (c_ar < torch.clamp(counts, max=C)[..., None]) & ~(
        (c_ar == C - 1) & (counts > C)[..., None]
    )


def _expert_ffn(params: dict, cfg: ModelConfig, de: torch.Tensor) -> torch.Tensor:
    """(B, E, C, D) -> (B, E, C, D) through every expert's FFN."""
    de = shard(de, "batch", "expert", None, "embed")
    h = shard(torch.einsum("becd,edf->becf", de, params["w_in"]), "batch", "expert", None, "ff")
    if cfg.mlp_act == "swiglu":
        g = torch.einsum("becd,edf->becf", de, params["w_gate"])
        h = torch.nn.functional.silu(shard(g, "batch", "expert", None, "ff")) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return shard(torch.einsum("becf,efd->becd", h, params["w_out"]),
                 "batch", "expert", None, "embed")


def _moe_rows(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Route, dispatch, run the experts and combine; returns (out, probs,
    ids).  Every step is per row."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    SK, C = S * K, capacity(cfg, S)
    dev = x.device
    # on a mesh, routing's integer counts and ranks need whole rows: a
    # partial sum of them is no count
    x = shard(x, "batch", "seq", "embed")
    probs, gate, ids = route(params, cfg, x)

    flat_e = ids.reshape(B, SK)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)   # (B, SK)
    counts = torch.nn.functional.one_hot(flat_e, E).sum(dim=1)   # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts

    # dispatch: slot (e, c) holds the token of expert e's rank-c assignment
    filled = _filled(counts, C)
    src = torch.clamp(starts[..., None] + torch.arange(C, device=dev), max=SK - 1)
    src = src.reshape(B, E * C)
    token = torch.gather(sort_idx, 1, src) // K                             # (B, E*C)
    xs = gather_rows(x, 1, token[..., None].expand(B, E * C, D))
    de = torch.where(filled.reshape(B, E * C, 1), xs, torch.zeros((), dtype=x.dtype, device=dev))
    eo = experts_local(_expert_ffn, params, cfg, de.reshape(B, E, C, D)).reshape(B, E * C, D)

    # combine: each assignment's rank in its expert, in (s, k) order
    rank_sorted = torch.arange(SK, device=dev)[None] - torch.gather(starts, 1, flat_e.gather(1, sort_idx))
    rank = torch.empty_like(rank_sorted).scatter_(1, sort_idx, rank_sorted).reshape(B, S, K)
    slot = ids * C + torch.clamp(rank, max=C - 1)
    w = torch.where(rank < C, gate, torch.zeros((), device=dev))
    # the K contributions of a token in ascending expert order
    order = torch.argsort(ids, dim=-1)
    slot, w = torch.gather(slot, 2, order), torch.gather(w, 2, order)
    got = gather_rows(eo, 1, slot.reshape(B, SK, 1).expand(B, SK, D)).reshape(B, S, K, D)
    out = got[:, :, 0].float() * w[..., 0, None]
    for k in range(1, K):
        out = out + got[:, :, k].float() * w[..., k, None]
    return out.to(x.dtype), probs, ids


def moe_apply(
    params: dict, cfg: ModelConfig, x: torch.Tensor, dispatch: L.Dispatch = L.PLAIN
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss).

    With ``dispatch.q_block`` set (a prefill whose rows' bits must not
    depend on the admission's shape) every row runs alone, so the
    router's and the experts' products have the same shapes however many
    prompts the call holds.  The router stays a plain fp32 ``@`` and the
    experts plain batched products, as in the reference (``matmul`` routes
    the ``layers._mm`` projections only)."""
    if dispatch.q_block is not None and x.shape[0] > 1:
        parts = [_moe_rows(params, cfg, x[i : i + 1]) for i in range(x.shape[0])]
        out, probs, ids = (torch.cat(t) for t in zip(*parts))
    else:
        out, probs, ids = _moe_rows(params, cfg, x)
    return out, aux_loss(probs, ids, cfg.moe.num_experts)
