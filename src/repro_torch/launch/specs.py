"""input_specs(): shape stand-ins for every model input; port of
``repro/launch/specs.py``.

No allocation: every stand-in is a tensor on the meta device (the
reference's ``ShapeDtypeStruct``), and the parameters' shapes come from
``Model.init`` run on the meta device, whose draws need no generator.
These drive the dry run's traces.  Per the assignment: modality frontends
are stubs, so whisper gets precomputed frame embeddings and llava gets
patch embeddings.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.arch.model_zoo import build
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import get
from repro_torch.train import optim

META = torch.device("meta")


# cells skipped per the assignment rule: long_500k needs sub-quadratic
# attention -> only SSM / hybrid / local:global archs run it.
def cell_is_live(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


def live_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.registry import ARCHS

    out = []
    for arch in sorted(ARCHS):
        for sname in SHAPES:
            if cell_is_live(ARCHS[arch], SHAPES[sname]):
                out.append((arch, sname))
    return out


def choose_microbatches(cfg: ModelConfig, shape: ShapeConfig, n_dp: int) -> int:
    """Smallest power-of-two microbatch count bounding per-device residual
    activation memory (L x B_mb x S x D x 2 bytes with per-layer remat) to
    ~2 GB."""
    if cfg.microbatch_override:
        return cfg.microbatch_override
    budget = 2 * 1024**3
    b_local = max(shape.global_batch // n_dp, 1)
    mb = 1
    layers = cfg.n_layers + cfg.encoder_layers
    while mb < b_local:
        resid = layers * (b_local // mb) * shape.seq_len * cfg.d_model * 2
        if resid <= budget:
            break
        mb *= 2
    return mb


def params_shapes(cfg: ModelConfig, device=META) -> Any:
    """The parameter tree on ``device`` (meta: shapes and dtypes only; a
    fake device under ``FakeTensorMode``); no generator, no allocation."""
    return build(cfg).init(None, device)


def opt_shapes(params: Any) -> Any:
    return optim.init_state(params)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, device=META) -> Any:
    """Decode/prefill cache shapes.  Decoder-only families build straight
    from the serve engine's slot-cache module so the dry-run traces exactly
    what the continuous-batching engine allocates; encdec keeps its model
    hook (cross-attention carries encoder state alongside)."""
    if cfg.family == "encdec":
        return build(cfg).init_caches(batch, max_len, device)
    from repro_torch.serve.kvcache import build_caches

    return build_caches(cfg, batch, max_len, device)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(
    arch: str, shape_name: str, n_dp: int = 1, cfg: ModelConfig | None = None
) -> dict[str, Any]:
    """Returns {cfg, shape, batch: {...}, caches?, enc_out?, microbatches?}
    of meta tensors for the given cell."""
    cfg = cfg or get(arch)
    shape = SHAPES[shape_name]
    i32 = torch.int32
    bf16 = getattr(torch, cfg.dtype)
    out: dict[str, Any] = {"cfg": cfg, "shape": shape}

    if shape.kind == "train":
        mb = choose_microbatches(cfg, shape, n_dp)
        b = shape.global_batch
        bm = b // mb
        batch = {"tokens": _spec((mb, bm, shape.seq_len), i32),
                 "labels": _spec((mb, bm, shape.seq_len), i32)}
        if cfg.family == "encdec":
            batch["frames"] = _spec((mb, bm, cfg.encoder_seq, cfg.d_model), bf16)
        if cfg.family == "vlm":
            batch["patches"] = _spec((mb, bm, cfg.n_patches, cfg.patch_dim), bf16)
        out.update(batch=batch, microbatches=mb)
    elif shape.kind == "prefill":
        b = shape.global_batch
        batch = {"tokens": _spec((b, shape.seq_len), i32)}
        if cfg.family == "encdec":
            batch["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), bf16)
        if cfg.family == "vlm":
            batch["patches"] = _spec((b, cfg.n_patches, cfg.patch_dim), bf16)
        out.update(batch=batch, caches=cache_shapes(cfg, b, shape.seq_len))
    else:  # decode
        b = shape.global_batch
        out.update(
            batch={"tokens": _spec((b, 1), i32)},
            caches=cache_shapes(cfg, b, shape.seq_len),
        )
        if cfg.family == "encdec":
            out["enc_out"] = _spec((b, cfg.encoder_seq, cfg.d_model), bf16)
    return out
