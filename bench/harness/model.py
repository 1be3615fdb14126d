"""A configuration file as the program and the reference take it, and the
seeded weights both are handed.

``dims`` reads the published keys of ``bench/configs/<name>.json`` (the
HuggingFace ``config.json`` names) into the plain sizes the reference and
the work counts use; ``port_config`` builds the program's ``ModelConfig``
from the same keys; ``make_weights`` draws the weights on the device in
the program's parameter layout (layer-stacked leaves) from the seed, in a
few large calls.
"""

from __future__ import annotations

import math

import torch

from bench.reference.lm import unflatten


def dims(model: dict) -> dict:
    """The sizes of a configuration, by plain names."""
    H = model["num_attention_heads"]
    d = {
        "layers": model["num_hidden_layers"],
        "d_model": model["hidden_size"],
        "heads": H,
        "kv_heads": model["num_key_value_heads"],
        "head_dim": model.get("head_dim") or model["hidden_size"] // H,
        "d_ff": model["intermediate_size"],
        "vocab": model["vocab_size"],
        "norm_eps": float(model["rms_norm_eps"]),
        "rope_theta": float(model["rope_theta"]),
        "dtype": model["torch_dtype"],
        "experts": model.get("num_local_experts", 0),
        "top_k": model.get("num_experts_per_tok", 0),
        "capacity_factor": float(model.get("capacity_factor", 0.0)),
    }
    if not model.get("tie_word_embeddings", False):
        raise ValueError(f"{model['name']}: the benchmark's layout ties the unembedding")
    return d


def port_config(model: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    d = dims(model)
    moe = None
    if d["experts"]:
        moe = MoEConfig(num_experts=d["experts"], top_k=d["top_k"], d_expert=d["d_ff"],
                        capacity_factor=d["capacity_factor"])
    return ModelConfig(
        name=model["name"], family="moe" if moe else "dense",
        n_layers=d["layers"], d_model=d["d_model"], n_heads=d["heads"],
        n_kv_heads=d["kv_heads"], d_ff=d["d_ff"], vocab=d["vocab"],
        head_dim=d["head_dim"], moe=moe, tie_embeddings=True,
        rope_theta=d["rope_theta"], norm_eps=d["norm_eps"], dtype=d["dtype"],
    )


def layout(d: dict) -> dict:
    """Every leaf of the parameter tree: path -> (shape, kind), kind one of
    ``embed``, ``proj`` (a projection or expert matrix), ``router`` and
    ``norm``.  The program's layout: each layer leaf stacked over layers."""
    L, D, V = d["layers"], d["d_model"], d["vocab"]
    H, KV, hd, F = d["heads"], d["kv_heads"], d["head_dim"], d["d_ff"]
    out = {
        "embed.tok": ((V, D), "embed"),
        "final_ln.scale": ((D,), "norm"),
        "layers.ln1.scale": ((L, D), "norm"),
        "layers.ln2.scale": ((L, D), "norm"),
        "layers.attn.wq": ((L, D, H * hd), "proj"),
        "layers.attn.wk": ((L, D, KV * hd), "proj"),
        "layers.attn.wv": ((L, D, KV * hd), "proj"),
        "layers.attn.wo": ((L, H * hd, D), "proj"),
    }
    if d["experts"]:
        E = d["experts"]
        out.update({
            "layers.moe.router": ((L, D, E), "router"),
            "layers.moe.w_in": ((L, E, D, F), "proj"),
            "layers.moe.w_gate": ((L, E, D, F), "proj"),
            "layers.moe.w_out": ((L, E, F, D), "proj"),
        })
    else:
        out.update({
            "layers.mlp.w_in": ((L, D, F), "proj"),
            "layers.mlp.w_gate": ((L, D, F), "proj"),
            "layers.mlp.w_out": ((L, F, D), "proj"),
        })
    return out


def make_weights(model: dict, seed: int, device) -> dict:
    """The parameter tree drawn from ``seed`` on ``device``: one normal
    draw for all matrices in the model's dtype, one in float32 for the
    router and the norm scales, each leaf a view of them scaled in place.
    Scales (the file's ``init``): embeddings ``embed_std``; projections
    and experts ``proj_gain / sqrt(d_model)``, so that a layer moves the
    residual stream and every layer shows in the logits; the router
    ``router_std``; norm scales ``1 + norm_std`` times a normal."""
    d, init = dims(model), model["init"]
    dtype = getattr(torch, d["dtype"])
    leaves = layout(d)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    big = [p for p, (_, k) in leaves.items() if k in ("embed", "proj")]
    small = [p for p, (_, k) in leaves.items() if k in ("router", "norm")]
    numel = {p: math.prod(leaves[p][0]) for p in leaves}
    mats = torch.empty(sum(numel[p] for p in big), dtype=dtype, device=device)
    mats.normal_(generator=g)
    f32 = torch.empty(sum(numel[p] for p in small), dtype=torch.float32, device=device)
    f32.normal_(generator=g)
    std = {"embed": init["embed_std"], "proj": init["proj_gain"] / math.sqrt(d["d_model"]),
           "router": init["router_std"], "norm": init["norm_std"]}
    flat = {}
    for buf, paths in ((mats, big), (f32, small)):
        off = 0
        for p in paths:
            shape, kind = leaves[p]
            v = buf[off:off + numel[p]].view(shape)
            off += numel[p]
            v.mul_(std[kind])
            if kind == "norm":
                v.add_(1.0)
            flat[p] = v
    return unflatten(flat)


def param_counts(d: dict) -> dict:
    """Parameters a token's forward pass multiplies by: ``layer`` (all of
    one layer's matrices), ``layer_active`` (a MoE layer counts its router
    and top-k experts only) and ``unembed`` (the tied vocabulary product)."""
    D, H, KV, hd, F = d["d_model"], d["heads"], d["kv_heads"], d["head_dim"], d["d_ff"]
    attn = D * (H + 2 * KV) * hd + H * hd * D
    if d["experts"]:
        layer = attn + D * d["experts"] + d["experts"] * 3 * D * F
        active = attn + D * d["experts"] + d["top_k"] * 3 * D * F
    else:
        layer = active = attn + 3 * D * F
    return {"layer": layer, "layer_active": active, "unembed": d["vocab"] * D}
