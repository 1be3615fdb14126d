"""Decoder-only LM: the dense, RWKV-6 and hybrid (recurrentgemma) paths;
port of ``repro/arch/transformer.py``.

One :class:`Model` per config exposing

    init(generator, device)                        -> params
    prefill(params, tokens, caches, ...)           -> (logits_last, caches)
    decode_step(params, tokens, caches, ...)       -> (logits, caches)
    init_caches(batch, max_len, device)            -> caches

Parameters keep the reference's layer-stacked layout (every leaf under
``params["layers"]`` has a leading ``n_layers`` axis; the hybrid family's
``params["groups"]`` leaves lead with ``(n_groups, rnn_per_attention)``
under ``rnn`` and ``(n_groups,)`` under ``attn``, ``params["tail"]``'s with
the remainder's rnn layers); the reference's ``lax.scan`` over those axes
becomes a Python loop that indexes one layer's weights and cache views at
a time.  Caches are updated in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.arch import layers as L
from repro_torch.arch import rglru as G
from repro_torch.arch import rwkv as R
from repro_torch.configs.base import ModelConfig

GLOBAL_WINDOW = 2**30  # "window" that never masks = global attention


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """(n_layers,) int32 sliding windows; 2^30 marks global layers."""
    if cfg.sliding_window is None:
        return np.full((cfg.n_layers,), GLOBAL_WINDOW, np.int32)
    if not cfg.global_every:
        return np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    return np.asarray(
        [
            GLOBAL_WINDOW if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
            for i in range(cfg.n_layers)
        ],
        np.int32,
    )


def unsupported_reason(cfg: ModelConfig) -> str | None:
    """Why the port cannot run ``cfg`` yet (the ROADMAP item that adds
    it), or None for the dense, RWKV-6 and hybrid paths it does run."""
    if cfg.family == "encdec":
        return "encoder-decoder models are ROADMAP A10c (arch/encdec.py)"
    if cfg.family == "vlm":
        return "the VLM patch projection is ROADMAP A10c"
    if cfg.moe is not None or cfg.family == "moe":
        return "MoE FFNs are ROADMAP A10c (arch/moe.py)"
    if cfg.global_every:
        return "the local:global backbone (gemma3) is ROADMAP A3b"
    return None


def attn_block_apply(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    window: int | None,
    positions: torch.Tensor | None,
    cache: dict | None,
    ragged_ok: bool | None = None,
    dispatch: L.Dispatch = L.PLAIN,
) -> torch.Tensor:
    h, _ = L.multihead_attention(
        p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
        positions=positions, causal=True, window=window, cache=cache,
        ragged_ok=ragged_ok, dispatch=dispatch,
    )
    x = x + h
    z = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], cfg, z, dispatch)


def rwkv_block_apply(
    p: dict, cfg: ModelConfig, x: torch.Tensor, *, cache: dict | None,
    dispatch: L.Dispatch = L.PLAIN,
) -> torch.Tensor:
    h, _ = R.rwkv_mix(p["wkv"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps), cache)
    x = x + h
    return x + L.mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps), dispatch)


def rnn_block_apply(
    p: dict, cfg: ModelConfig, x: torch.Tensor, *, cache: dict | None,
    dispatch: L.Dispatch = L.PLAIN,
) -> torch.Tensor:
    h, _ = G.rglru_block(p["rnn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps), cache)
    x = x + h
    return x + L.mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps), dispatch)


def _index(tree, i: int):
    """Layer ``i`` of a layer-stacked dict tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        why = unsupported_reason(self.cfg)
        if why is not None:
            raise NotImplementedError(f"{self.cfg.name}: {why}")

    # ------------------------------------------------------------- params --
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters from the reference's distributions (normal
        0.02 embeddings, normal 0.02/sqrt(d) projections, unit norm
        scales; for RWKV-6 also ``mu`` 0.5, ``w0`` -3, a zero ``w_lora_b``
        and ``u`` normal 0.5 in fp32; for the RG-LRU an fp32 ``lam`` and a
        normal 0.02 conv kernel), drawn from ``generator``, which must live
        on ``device``.
        The draws differ from ``jax.random``'s; tests that compare the two
        packages convert one tree with ``repro_torch.bridge``."""
        cfg = self.cfg

        def blocks(kind: str, lead: tuple) -> dict:
            mixer = {"wkv": R.rwkv_init, "rnn": G.rglru_init,
                     "attn": L.attention_init}[kind]
            return {
                "ln1": {"scale": torch.ones(lead + (cfg.d_model,), device=device)},
                kind: mixer(generator, cfg, device, lead),
                "ln2": {"scale": torch.ones(lead + (cfg.d_model,), device=device)},
                "mlp": L.mlp_init(generator, cfg, device, lead),
            }

        if cfg.family == "hybrid":
            ng, rem = divmod(cfg.n_layers, cfg.rnn_per_attention + 1)
            body = {
                "groups": {
                    "rnn": blocks("rnn", (ng, cfg.rnn_per_attention)),
                    "attn": blocks("attn", (ng,)),
                },
                "tail": blocks("rnn", (rem,)) if rem else {},
            }
        else:
            body = {"layers": blocks("wkv" if cfg.mixer == "rwkv6" else "attn",
                                     (cfg.n_layers,))}
        return {
            "embed": L.embedding_init(generator, cfg, device),
            **body,
            "final_ln": L.rmsnorm_init(cfg.d_model, device),
        }

    # ------------------------------------------------------------ forward --
    def _backbone(
        self,
        params: dict,
        x: torch.Tensor,
        positions: torch.Tensor | None,
        caches: dict | None,
        dispatch: L.Dispatch,
    ) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return self._backbone_hybrid(params, x, positions, caches, dispatch)
        if cfg.mixer == "rwkv6":
            for i in range(cfg.n_layers):
                x = rwkv_block_apply(
                    _index(params["layers"], i), cfg, x,
                    cache=None if caches is None else _index(caches, i),
                    dispatch=dispatch,
                )
            return x
        wins = layer_windows(cfg)
        # the ragged-decode ring invariant (ring extent <= window) checked
        # once over all layers and passed down as a hint
        ragged = None
        if caches is not None:
            if "kpool" in caches:
                ragged = True  # paged caches exist only for all-global configs
            else:
                ragged = bool((wins >= caches["k"].shape[2]).all())
        # ABFT: the reference scans its layers, so every layer's check sites
        # share one trace-time call index and the fault's `layer` picks the
        # layer.  The counters restart at every layer to address the same
        # sites; each layer's verdicts are ORed as the scan drains them.
        trace = dispatch.trace
        if trace is not None:
            sites = (trace.mm_calls, trace.attn_calls)
            layer_flags = []
        for i in range(cfg.n_layers):
            if trace is not None:
                trace.layer = i
                trace.mm_calls, trace.attn_calls = sites
            x = attn_block_apply(
                _index(params["layers"], i), cfg, x,
                window=int(wins[i]), positions=positions,
                cache=None if caches is None else _index(caches, i),
                ragged_ok=ragged, dispatch=dispatch,
            )
            if trace is not None:
                layer_flags.append(trace.drain(x.device))
        if trace is not None:
            trace.layer = None
            trace.flags.append(torch.stack(layer_flags).any())
        return x

    def _backbone_hybrid(self, params, x, positions, caches, dispatch):
        """Groups of (rnn x rnn_per_attention, attention), then the tail's
        rnn layers; every attention layer has the sliding window."""
        cfg = self.cfg
        ng, rem = divmod(cfg.n_layers, cfg.rnn_per_attention + 1)
        for gi in range(ng):
            p = _index(params["groups"], gi)
            c = None if caches is None else _index(caches["groups"], gi)
            for r in range(cfg.rnn_per_attention):
                x = rnn_block_apply(
                    _index(p["rnn"], r), cfg, x,
                    cache=None if c is None else _index(c["rnn"], r), dispatch=dispatch,
                )
            x = attn_block_apply(
                p["attn"], cfg, x, window=cfg.sliding_window, positions=positions,
                cache=None if c is None else c["attn"], dispatch=dispatch,
            )
        for i in range(rem):
            x = rnn_block_apply(
                _index(params["tail"], i), cfg, x,
                cache=None if caches is None else _index(caches["tail"], i),
                dispatch=dispatch,
            )
        return x

    def logits_fn(
        self,
        params: dict,
        x: torch.Tensor,
        positions: torch.Tensor | None = None,
        caches: dict | None = None,
        dispatch: L.Dispatch = L.PLAIN,
    ) -> tuple[torch.Tensor, dict | None]:
        x = self._backbone(params, x, positions, caches, dispatch)
        x = L.rmsnorm(params["final_ln"], x, self.cfg.norm_eps)
        return L.unembed(params["embed"], x, dispatch), caches

    # -------------------------------------------------------------- serve --
    def init_caches(self, batch: int, max_len: int, device=None) -> dict:
        from repro_torch.serve.kvcache import build_caches

        return build_caches(self.cfg, batch, max_len, device)

    def prefill(
        self,
        params: dict,
        tokens: torch.Tensor,
        caches: dict,
        last_index: torch.Tensor | None = None,
        dispatch: L.Dispatch = L.PLAIN,
        from_cursor: bool = False,
    ) -> tuple[torch.Tensor, dict]:
        """last_index: per-row index of the last real token, for prompts
        right-padded to a bucket length (default: the final position).
        ``from_cursor``: the tokens continue prompts already in ``caches``
        (a chunk of the chunked-prefill lane), so positions start at each
        row's ``len`` cursor rather than at 0, as the reference's
        ``logits_fn(positions=None)`` derives them.

        The reference unembeds every position and then selects one row per
        prompt; the final norm and the unembedding are row-wise, so this
        selects first and unembeds only the rows it returns.  With
        ``dispatch.q_block`` set it normalizes and unembeds each row alone,
        so the row's bits do not depend on how many prompts the call holds."""
        x = L.embed(params["embed"], tokens)
        positions = None
        if not from_cursor:
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x = self._backbone(params, x, positions, caches, dispatch)
        if last_index is None:
            x = x[:, -1]
        else:
            x = x[torch.arange(x.shape[0], device=x.device), last_index.long()]
        if dispatch.q_block is not None:
            return torch.cat([self._head(params, x[i : i + 1], dispatch)
                              for i in range(x.shape[0])]), caches
        return self._head(params, x, dispatch), caches

    def _head(self, params: dict, x: torch.Tensor, dispatch: L.Dispatch) -> torch.Tensor:
        x = L.rmsnorm(params["final_ln"], x, self.cfg.norm_eps)
        return L.unembed(params["embed"], x, dispatch)

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,
        caches: dict,
        dispatch: L.Dispatch = L.PLAIN,
    ) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) -> (logits (B, V), caches)."""
        x = L.embed(params["embed"], tokens)
        logits, caches = self.logits_fn(params, x, caches=caches, dispatch=dispatch)
        return logits[:, -1], caches
