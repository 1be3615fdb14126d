"""Config system: model + parallelism + run configs.

The port's own copy of ``repro/configs/base.py``: the PyTorch package
imports nothing of the JAX package, so the config dataclasses live here
too, field for field, and the parity tests compare the two copies.

Every assigned architecture is a `ModelConfig` in its own module under
repro_torch/configs/; `repro_torch.configs.registry` maps --arch ids to them.  Reduced
("smoke") variants shrink layers/width/experts for CPU tests while keeping
the family wiring identical.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
Mixer = Literal["attention", "rwkv6", "rglru"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    mixer: Mixer = "attention"
    # attention pattern: every `global_every`-th layer is global, the rest
    # use `sliding_window` local attention (None = all global/full).
    sliding_window: int | None = None
    global_every: int | None = None
    # hybrid (recurrentgemma): layers cycle [recurrent]*rnn_per + [attn]
    rnn_per_attention: int = 0
    rnn_width: int | None = None
    conv1d_width: int = 4
    moe: MoEConfig | None = None
    # encoder-decoder (whisper): encoder depth/length; frontend is a stub
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: patch-embedding stub
    n_patches: int = 0
    patch_dim: int = 0
    mlp_act: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # set for archs where full attention makes 500k contexts intractable
    subquadratic: bool = False
    # ---- performance knobs (hillclimbed in EXPERIMENTS.md §Perf) ----
    # "full": recompute everything in bwd; "dots": save matmul outputs
    remat_policy: str = "full"
    # skip fully-masked kv blocks in causal blockwise attention (unrolls
    # the q-block loop; halves prefill attention FLOPs)
    causal_skip: bool = False
    # pin the microbatch grad accumulator to the param sharding (turns the
    # per-mb full-gradient all-reduce into a reduce-scatter)
    shard_grad_accum: bool = False
    # force the microbatch count (0 = auto from the 2 GB activation budget);
    # FSDP param-gather volume scales with it (paper: loop blocking)
    microbatch_override: int = 0
    # serve cells: keep params TP-sharded + data-replicated instead of
    # ZeRO/FSDP (no per-token param all-gather); training keeps FSDP
    serve_tp_params: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.mixer == "attention" or self.family in ("encdec",):
            per += d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
            per += hd * self.n_heads * d
        if self.mixer == "rwkv6":
            per += 5 * d * d + d * d  # r,k,v,g,w(+lora approx) + out
        if self.moe:
            per_e = d * self.moe.d_expert * (3 if self.mlp_act == "swiglu" else 2)
            per += self.moe.num_experts * per_e + d * self.moe.num_experts
        else:
            per += d * self.d_ff * (3 if self.mlp_act == "swiglu" else 2)
        total = emb + self.n_layers * per
        if self.family == "encdec":
            total += self.encoder_layers * per
        return total

    def active_params_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if not self.moe:
            return self.params_count()
        d = self.d_model
        per_e = d * self.moe.d_expert * (3 if self.mlp_act == "swiglu" else 2)
        inactive = (self.moe.num_experts - self.moe.top_k) * per_e
        return self.params_count() - self.n_layers * inactive

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.moe:
            kw["moe"] = MoEConfig(
                num_experts=4, top_k=min(self.moe.top_k, 2), d_expert=32
            )
        if self.sliding_window:
            kw["sliding_window"] = 8
        if self.global_every:
            # one full (local*(ge-1), global) group + one tail local layer
            kw["n_layers"] = self.global_every + 1
        if self.rnn_per_attention:
            kw["rnn_width"] = 64
            # keep one full (rnn, ..., attn) group plus one tail rnn layer
            kw["n_layers"] = self.rnn_per_attention + 2
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 16
        if self.n_patches:
            kw["n_patches"] = 4
            kw["patch_dim"] = 32
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
