"""The plain reference of the benchmark's decoder-only models, in float32.

Plain PyTorch operations on one sequence at a time, with no kernel, cache
or batching, and nothing of the program under test: the benchmark hands it
the same weights it hands the program (the tree ``bench.harness.model``
makes), and it works everything else out itself.

The equations are the ones the configuration files state (a pre-norm
decoder with RMSNorm, rotary positions on split halves, grouped-query
attention scaled by 1/sqrt(head_dim), a SwiGLU feed-forward network or a
mixture of experts, a final RMSNorm and the tied unembedding), with the
program's documented departures from the published models (listed in each
configuration's ``departures``), so that a difference from the program is
a fault of the program:

  * mixture of experts: a float32 router, softmax over the experts, the
    top-k by a stable descending sort, the k gates renormalised to sum to
    one; Switch capacity per routed row, ``C = max(1, ceil(S k f / E))``
    slots an expert for a row of ``S`` tokens, assignments ranked within
    their expert in (token, k) order, ranks ``>= C`` dropped, and the
    rank ``C - 1`` assignment of an expert that overflows left with no
    output (its gate still counted);
  * a served request's prompt is routed as one row; every token decoded
    after it is routed alone (a row of one token drops nothing).

``precision="fp8"`` rounds both operands of every projection to float8
(e4m3, one scale per row of the activations and per column of the weights)
before the product: the control that shows the comparison would catch a
lower precision than the configuration's bfloat16.  TF32 is switched off
for every product here.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32.  The
    gradient passes straight through."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t).detach()


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32, or with both operands rounded to float8."""
    if precision == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, -2)
    elif precision != "fp32":
        raise ValueError(f"precision must be 'fp32' or 'fp8': {precision!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, d), position t at row t; rotates the two halves."""
    T, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def attention(p: dict, dims: dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    T = h.shape[0]
    H, KV, hd = dims["heads"], dims["kv_heads"], dims["head_dim"]
    q = rope(mm(h, p["wq"], precision).view(T, H, hd), dims["rope_theta"])
    k = rope(mm(h, p["wk"], precision).view(T, KV, hd), dims["rope_theta"])
    v = mm(h, p["wv"], precision).view(T, KV, hd)
    qg = q.view(T, KV, H // KV, hd)
    scores = torch.einsum("tkgd,skd->kgts", qg, k) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    ctx = torch.einsum("kgts,skd->tkgd", torch.softmax(scores, dim=-1), v)
    return mm(ctx.reshape(T, H * hd), p["wo"], precision)


def swiglu(z: torch.Tensor, w_in, w_gate, w_out, precision: str) -> torch.Tensor:
    g = torch.nn.functional.silu(mm(z, w_gate, precision))
    return mm(g * mm(z, w_in, precision), w_out, precision)


def routed_rows(T: int, prompt_len: int | None) -> list[tuple[int, int]]:
    """The rows the experts route over: the prompt as one row, each later
    token alone (``prompt_len`` None: the whole sequence is one row)."""
    if prompt_len is None:
        return [(0, T)]
    return [(0, prompt_len)] + [(t, t + 1) for t in range(prompt_len, T)]


def moe(p: dict, dims: dict, z: torch.Tensor, rows, precision: str) -> torch.Tensor:
    E, K, cf = dims["experts"], dims["top_k"], dims["capacity_factor"]
    probs = torch.softmax(z @ p["router"], dim=-1)            # float32 router
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :K], ids[:, :K]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    weight = torch.ones_like(gate, dtype=torch.bool)          # gate counted
    output = torch.ones_like(gate, dtype=torch.bool)          # expert output kept
    for a, b in rows:
        S = b - a
        if S == 1:
            continue  # one token's k distinct experts never overflow a slot
        C = max(1, math.ceil(S * K * cf / E))
        flat = ids[a:b].reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=E)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(S * K, device=z.device) - starts[flat[order]]
        rank, over = rank.view(S, K), (counts > C)[ids[a:b]]
        weight[a:b] = rank < C
        output[a:b] = (rank < C - 1) | ((rank == C - 1) & ~over)
    out = torch.zeros_like(z)
    for e in range(E):
        t_idx, k_idx = torch.nonzero((ids == e) & weight & output, as_tuple=True)
        if t_idx.numel() == 0:
            continue
        y = swiglu(z[t_idx], p["w_in"][e], p["w_gate"][e], p["w_out"][e], precision)
        out = out.index_add(0, t_idx, y * gate[t_idx, k_idx][:, None])
    return out


def layer_params(weights: dict, i: int) -> dict:
    """Layer ``i``'s weights in float32 (views of float32 leaves, so a
    gradient reaches the stacked leaf)."""
    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v[i].float() for k, v in tree.items()}
    return f32(weights["layers"])


def forward(weights: dict, dims: dict, tokens: torch.Tensor, *, prompt_len: int | None = None,
            precision: str = "fp32") -> torch.Tensor:
    """Logits (T, vocab) in float32 at every position of ``tokens`` (T,);
    each layer's weights are upcast as it runs."""
    eps = dims["norm_eps"]
    emb = weights["embed"]["tok"].float()
    x = emb[tokens]
    rows = routed_rows(tokens.shape[0], prompt_len)
    for i in range(dims["layers"]):
        p = layer_params(weights, i)
        x = x + attention(p["attn"], dims, rmsnorm(x, p["ln1"]["scale"], eps), precision)
        z = rmsnorm(x, p["ln2"]["scale"], eps)
        if "moe" in p:
            x = x + moe(p["moe"], dims, z, rows, precision)
        else:
            m = p["mlp"]
            x = x + swiglu(z, m["w_in"], m["w_gate"], m["w_out"], precision)
    final = weights["final_ln"]["scale"].float()
    return mm(rmsnorm(x, final, eps), emb.T, precision)


def served_rows(weights: dict, dims: dict, prompt: torch.Tensor, served: torch.Tensor,
                precision: str = "fp32") -> torch.Tensor:
    """The reference's logits (n, vocab) at the positions that chose a
    served request's ``n`` tokens: the prompt's last position, then each
    served token's but the last."""
    seq = torch.cat([prompt, served[:-1]])
    logits = forward(weights, dims, seq, prompt_len=prompt.shape[0], precision=precision)
    return logits[prompt.shape[0] - 1:]


def gaps(rows: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below its row's largest."""
    return rows.max(dim=-1).values - rows.gather(1, tokens[:, None])[:, 0]


# ------------------------------------------------------------- training --

def leaves(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The leaves of a nested dict by their dotted path."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parts, last = path.split(".")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


def loss_and_grads(params: dict[str, torch.Tensor], dims: dict, tokens, labels,
                   precision: str = "fp32") -> tuple[float, dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over every (row, position) of
    ``tokens``/``labels`` (B, T) and its gradient by leaf, one row at a
    time, the gradients summed in float32."""
    tree = unflatten(params)
    names = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total, B = 0.0, tokens.shape[0]
    for r in range(B):
        logits = forward(tree, dims, tokens[r], precision=precision)
        loss = torch.nn.functional.cross_entropy(logits, labels[r]) / B
        for k, g in zip(names, torch.autograd.grad(loss, [params[k] for k in names])):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


def adamw_step(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One AdamW step in float32, in place: the gradients clipped by their
    global norm, linear warm-up then cosine decay, decoupled weight decay,
    bias-corrected moments.  Returns the clipped gradients."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
    state["step"] += 1
    s = float(state["step"])
    warm = min(s / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((s - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    lr = opt["lr"] * warm * decay
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** s, 1 - b2 ** s
    clipped = {}
    with torch.no_grad():
        for k, p in params.items():
            g = clipped[k] = grads[k] * scale
            m = state["m"].setdefault(k, torch.zeros_like(p))
            v = state["v"].setdefault(k, torch.zeros_like(p))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + opt["eps"]) + opt["weight_decay"] * p))
    return clipped


def train(weights: dict, dims: dict, batches: list[dict], opt: dict, steps: int,
          precision: str = "fp32") -> dict:
    """``steps`` AdamW steps from ``weights`` (upcast to float32) on
    ``batches``: each step's loss, each leaf's norm of the first step's
    clipped gradient, and each leaf's norm of its change after the last
    step, by leaf path."""
    params = {k: v.detach().float().clone().requires_grad_() for k, v in leaves(weights).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    state = {"m": {}, "v": {}, "step": 0}
    losses, first = [], None
    for s in range(steps):
        loss, grads = loss_and_grads(params, dims, batches[s]["tokens"], batches[s]["labels"],
                                     precision)
        clipped = adamw_step(params, grads, state, opt)
        del grads
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in clipped.items()}
        del clipped
        losses.append(loss)
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k])) for k in params}
    return {"losses": losses, "first_grad": first, "change": change}
