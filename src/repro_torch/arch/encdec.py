"""Whisper-style encoder-decoder; port of ``repro/arch/encdec.py``.

The audio frontend is a stub, as in the reference: callers hand in frame
embeddings ``(B, T_enc, d_model)``.  The encoder is a bidirectional
self-attention stack over the frames, then ``enc_ln``.  Each decoder layer
runs causal self-attention on its KV cache, then cross-attention into the
encoder output (no RoPE, no mask), then the MLP.  Decode recomputes the
cross-attention K/V from ``enc_out`` every step, as the reference does;
``enc_out`` travels beside the caches as the decode state.

Parameters keep the reference's layout: ``enc_layers`` and ``dec_layers``
are layer-stacked trees; the reference's ``lax.scan`` over them becomes a
loop over layer views.  ``Dispatch`` reaches every projection
(``layers._mm``) and the decoder's cached self-attention; the encoder's
and the cross-attention's attention stay on the plain path.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.arch import layers as L
from repro_torch.arch.transformer import _index
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class EncDecModel:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random parameters from the reference's distributions (see
        ``transformer.Model.init``), drawn from ``generator`` on
        ``device``."""
        cfg = self.cfg

        def norm(lead):
            return {"scale": torch.ones(lead + (cfg.d_model,), device=device)}

        def attn(lead):
            return L.attention_init(generator, cfg, device, lead)

        enc = (cfg.encoder_layers,)
        dec = (cfg.n_layers,)
        return {
            "embed": L.embedding_init(generator, cfg, device),
            "enc_layers": {"ln1": norm(enc), "attn": attn(enc), "ln2": norm(enc),
                           "mlp": L.mlp_init(generator, cfg, device, enc)},
            "dec_layers": {"ln1": norm(dec), "self_attn": attn(dec), "ln_x": norm(dec),
                           "cross_attn": attn(dec), "ln2": norm(dec),
                           "mlp": L.mlp_init(generator, cfg, device, dec)},
            "enc_ln": L.rmsnorm_init(cfg.d_model, device),
            "final_ln": L.rmsnorm_init(cfg.d_model, device),
        }

    def encode(self, params: dict, frames: torch.Tensor,
               dispatch: L.Dispatch = L.PLAIN) -> torch.Tensor:
        """frames: (B, T_enc, D) precomputed embeddings -> (B, T_enc, D)."""
        cfg = self.cfg
        x = frames
        for i in range(cfg.encoder_layers):
            p = _index(params["enc_layers"], i)
            h, _ = L.multihead_attention(
                p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                causal=False, dispatch=dispatch,
            )
            x = x + h
            x = x + L.mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps), dispatch)
        return L.rmsnorm(params["enc_ln"], x, cfg.norm_eps)

    def _decoder(self, params, x, enc_out, positions, caches, dispatch):
        cfg = self.cfg
        for i in range(cfg.n_layers):
            p = _index(params["dec_layers"], i)
            h, _ = L.multihead_attention(
                p["self_attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                positions=positions, causal=True,
                cache=None if caches is None else _index(caches, i), dispatch=dispatch,
            )
            x = x + h
            h, _ = L.multihead_attention(
                p["cross_attn"], cfg, L.rmsnorm(p["ln_x"], x, cfg.norm_eps),
                kv_x=enc_out, causal=False, use_rope=False, dispatch=dispatch,
            )
            x = x + h
            x = x + L.mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps), dispatch)
        return x

    def _head(self, params, x, dispatch):
        """Logits of the last position (the final norm and the unembedding
        are row-wise, so only that row is computed)."""
        x = L.rmsnorm(params["final_ln"], x[:, -1], self.cfg.norm_eps)
        return L.unembed(params["embed"], x, dispatch)

    def init_caches(self, batch: int, max_len: int, device=None) -> dict:
        """The decoder's self-attention caches, leaves ``(n_layers, batch,
        max_len, ...)``."""
        from repro_torch.serve.kvcache import _stack

        return _stack(L.init_kv_cache(self.cfg, batch, max_len, None, device), self.cfg.n_layers)

    def prefill(self, params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                caches: dict, dispatch: L.Dispatch = L.PLAIN):
        """Encode ``frames`` and run the prompt ``tokens`` (B, T) through
        the decoder -> (last logits (B, V), (caches, enc_out))."""
        enc_out = self.encode(params, frames, dispatch)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x = L.embed(params["embed"], tokens)
        x = self._decoder(params, x, enc_out, positions, caches, dispatch)
        return self._head(params, x, dispatch), (caches, enc_out)

    def decode_step(self, params: dict, tokens: torch.Tensor, state: tuple,
                    dispatch: L.Dispatch = L.PLAIN):
        """tokens: (B, 1); state: (caches, enc_out) -> (logits (B, V),
        state), the caches updated in place."""
        caches, enc_out = state
        x = L.embed(params["embed"], tokens)
        x = self._decoder(params, x, enc_out, None, caches, dispatch)
        return self._head(params, x, dispatch), (caches, enc_out)
