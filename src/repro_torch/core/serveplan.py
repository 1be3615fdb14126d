"""Serve-config planning: the whole serving configuration as a mapping space.

The port's copy of the reference's ``core/serveplan.py``, priced for the
H100.  The paper's argument (§6.3) is that *resource allocation* -- not
dataflow -- dominates energy and performance.  The serving stack's own
knobs (``block_size``, ``num_blocks``, slot count, ``prefill_chunk``,
``token_budget``) are such an allocation: one decode step of the served
transformer is priced analytically, the joint knob space is swept under an
iso-HBM constraint, and the winner is persisted per ``(hardware, model,
workload)`` the way GEMM tiles are (``REPRO_TORCH_TILE_CACHE`` ->
``REPRO_TORCH_SERVE_PLAN_CACHE``).

One decode step, at steady state with ``rows`` live requests at mean context
``ctx``, costs:

  * **decode GEMMs** -- qkv / attention-out / mlp / unembed with
    ``M = rows``, priced by the plan of the kernel that runs them.  On the
    H100 (the default :class:`ServeHardware`) that is the port's GEMM,
    ``kernels/matmul/matmul.plan``: up to 64 rows the skinny body, one
    64-column tile a block, K split across a thread-block cluster whose
    partials are combined in the cluster, not in HBM.  Its HBM words are
    what ``csrc/matmul.cu`` moves: the weight once per M tile (once at
    decode, where the bucket covers M), the activation rows once (the
    column tiles meet in L2; TMA fills the bucket's missing rows without a
    read) and the output once.  A plan whose shared memory exceeds a
    block's makes the point infeasible.  Under ``matmul="xla"`` the engine
    runs cuBLAS; the planner prices the kernel all the same.
    On the TPU description (:meth:`ServeHardware.tpu_v5e`) the reference's
    pricing runs unchanged: the paper's blocking search
    (``mapper.choose_matmul_tiles`` on the 2-level VMEM/HBM hierarchy) and
    ``MatmulTiles.hbm_words``.
  * **decode attention** -- on the H100 what ``csrc/decode_attention.cu``
    moves for a row and a layer: ``ceil(ctx / block_size)`` whole K and V
    splits per kv head (the tail split is read in full: the fragmentation
    cost of a large block), the block-table entries (int32, paged only; the
    contiguous kernel computes its rows), and the fp32 workspace of every
    live split: G score rows written by the scores pass and read back by
    the partials pass, then G * (head_dim + 2) partials written and read by
    the ordered replay (``decode_attention.workspace_floats``).  Both
    layouts walk only the live splits.  A split whose shared memory
    (``decode_attention.plan``) exceeds a block's makes the point
    infeasible.  On the TPU description: the reference's
    ``costmodel.attention_gather_words`` (the contiguous twin pins
    ``kv_splits = max_len / decode_block`` and pays the full combine);
  * **prefill lane** -- chunked admission streams ``prefill_chunk``-token
    tiles through the scratch lane under ``token_budget``; steady-state
    turnover demands ``rows * prompt_len / decode_len`` prefill tokens per
    step, and a lane that cannot keep up caps occupancy (the admission-bound
    regime).  Monolithic admission (``prefill_chunk=0``) does the same total
    work but pays TTFT as one whole-prompt stall.

Throughput is a max() roofline -- compute at ``peak_flops`` against HBM
words at the HBM level's bandwidth -- plus a :class:`Calibration` term
(fixed per-step overhead, per-row, per-gathered-block and chunked-lane
costs) fitted ONCE against measured steps (``chip_smoke.py`` phase 13 fits
it on the card).  On the H100 a decode step is host-bound (the card idles
most of it), so the calibration, not the roofline, carries nearly all of a
calibrated prediction.  Candidates are folded through ``dse.pareto_prune``
over (time-per-token, TTFT, energy-per-token) and the winner maximizes
predicted tokens/sec.

Feasibility is capacity-driven, like every Interstellar sweep: the kernels'
plans must fit a block's shared memory (the TPU description: GEMM tiles
must fit VMEM, double-buffered), weights + the KV pool must fit HBM, and
the iso-HBM constraint sizes every candidate's pool from the same
``kv_budget_tokens`` so allocations -- not budgets -- are what is compared.

This module is numpy-only and imports no torch: the H100 pricing imports
the two kernels' plan functions (pure Python, in modules that import torch)
when it first prices a step.  ``ServeConfig.autotune()`` (serve/engine.py)
converts the planned knobs into an engine config, and ``launch/serve.py
--autotune`` surfaces it on the CLI.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from pathlib import Path

import numpy as np

from repro_torch import hw as h100
from repro_torch.core import energy as en
from repro_torch.core.costmodel import attention_gather_words
from repro_torch.core.dse import pareto_prune
from repro_torch.core.jsonstore import atomic_write_json, load_json_dict
from repro_torch.core.mapper import choose_matmul_tiles
from repro_torch.core.schedule import ArraySpec, MemLevel

WORD_BYTES = 2  # bf16 serving, like the paper's 16-bit arithmetic (§5)

# Bump whenever the step model or the sweep changes, so stale plans from an
# older algorithm are never served out of the on-disk cache.
_PLAN_CACHE_SCHEMA = "v1"
# The port keeps its own store, apart from the reference's:
# ``build/repro_torch/serve_plans.json`` in the checkout by default, elsewhere
# with REPRO_TORCH_SERVE_PLAN_CACHE (an empty string disables persistence).
_PLAN_CACHE_ENV = "REPRO_TORCH_SERVE_PLAN_CACHE"
_PLAN_CACHE_DEFAULT = str(
    Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "serve_plans.json"
)


# -------------------------------------------------------------- hardware --


@dataclasses.dataclass(frozen=True)
class ServeHardware:
    """The serving chip as the paper would describe it: a compute array
    plus a 2-level (on-chip, HBM) memory hierarchy with capacities and
    bandwidths.  The defaults are the H100 (``repro_torch/hw.py``): its HBM
    and dense bf16 peak, and as the on-chip level the shared memory the
    GEMM's ring uses (``hw.hopper_gemm_levels()``).  ``target`` names whose
    plans price a step: ``"hopper"``, the port's kernels, or ``"tpu"``, the
    reference's TPU tile search (:meth:`tpu_v5e`, the reference's default
    description, which the parity tests plan on).  ``array`` and
    ``clock_hz`` only identify the chip: compute is priced at
    ``peak_flops``, and the clock cancels out of the roofline's seconds."""

    name: str = "h100-sxm"
    hbm_bytes: int = h100.HBM_BYTES
    hbm_bytes_per_s: float = h100.HBM_BYTES_PER_S
    peak_flops: float = h100.BF16_FLOPS_PER_S
    smem_bytes: int = h100.hopper_gemm_levels()[1].capacity_bytes
    array: ArraySpec = ArraySpec(dims=(h100.SM_COUNT,))
    clock_hz: float = h100.CLOCK_HZ
    target: str = "hopper"

    def __post_init__(self):
        if self.target not in ("hopper", "tpu"):
            raise ValueError(f"target must be 'hopper' or 'tpu': {self.target!r}")

    @classmethod
    def tpu_v5e(cls) -> "ServeHardware":
        """The reference's default: the TPU v5e constants shared with its
        benchmarks/roofline.py (16 GB HBM at 819 GB/s, 197 TFLOP/s, 64 MB
        VMEM, a 128x128 MXU).  Not this card."""
        return cls(
            name="tpu-v5e",
            hbm_bytes=en.TPU_HBM_BYTES,
            hbm_bytes_per_s=en.TPU_HBM_BYTES_PER_S,
            peak_flops=en.TPU_PEAK_FLOPS_BF16,
            smem_bytes=en.TPU_VMEM_BYTES,
            array=ArraySpec(dims=(128, 128)),
            clock_hz=940e6,
            target="tpu",
        )

    def levels(self) -> tuple[MemLevel, ...]:
        """The serve hierarchy in the core IR's own terms (words/cycle at
        the planner's clock), so the planner prices with the same MemLevel
        vocabulary as every other sweep in core/."""
        return (
            MemLevel(
                "VMEM" if self.target == "tpu" else "SMEM",
                capacity_bytes=self.smem_bytes,
                bandwidth_words_per_cycle=float("inf"),
                double_buffered=True,
            ),
            MemLevel(
                "HBM",
                capacity_bytes=self.hbm_bytes,
                bandwidth_words_per_cycle=(
                    self.hbm_bytes_per_s / self.clock_hz / WORD_BYTES
                ),
                double_buffered=False,
            ),
        )

    def fingerprint(self) -> tuple:
        # the TPU description's is the reference's, so their plan keys agree
        return (
            self.name, self.hbm_bytes, round(self.hbm_bytes_per_s),
            round(self.peak_flops), self.smem_bytes, self.array.dims,
            round(self.clock_hz),
        ) + (() if self.target == "tpu" else (self.target,))


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """What the planner optimizes for: offered concurrency and the shape of
    a request.  ``decode_len`` sets the steady-state admission turnover
    (each slot re-admits every ``decode_len`` steps)."""

    concurrency: int = 16
    prompt_len: int = 64
    decode_len: int = 64

    def __post_init__(self):
        if min(self.concurrency, self.prompt_len, self.decode_len) < 1:
            raise ValueError(f"workload fields must be >= 1: {self}")

    def mean_ctx(self, max_len: int) -> int:
        """Mean live KV length mid-decode: the whole prompt plus half the
        generated tokens, clamped into the ring."""
        return max(1, min(max_len - 1, self.prompt_len + self.decode_len // 2))

    def fingerprint(self) -> tuple:
        return (self.concurrency, self.prompt_len, self.decode_len)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Bridges the analytic roofline to measured steps with four host-side
    terms the roofline cannot see: a fixed per-step overhead (dispatch,
    host sync -- dominant on CPU smoke runs, small on a real TPU, and on
    the H100, whose decode step is host-bound, nearly the whole step), a
    per-row cost, a per-gathered-physical-block cost (the paged kernel's
    block-table indirection), and a fixed surcharge when the chunked
    prefill lane is armed (its extra program dispatch per step).  ``fit``
    solves them from measured (StepCost, seconds) reference pairs ONCE —
    anchors should span the features being fitted (two occupancies, a
    paged member, a chunked member) — and the planner then ranks every
    other candidate with the same terms."""

    step_overhead_s: float = 0.0
    per_row_s: float = 0.0
    per_block_s: float = 0.0
    chunk_overhead_s: float = 0.0

    @classmethod
    def fit(cls, pairs) -> "Calibration":
        """Least-squares ``measured = roofline + c0 + c1*rows +
        c2*paged_blocks + c3*chunked`` over measured reference steps.
        Features the anchor set cannot distinguish (zero spread across
        pairs) are dropped and fitted as 0; negative solutions clamp to 0
        — a measured step can't beat its own roofline."""
        if not pairs:
            return cls()
        resid = np.array([m - c.roofline_s for c, m in pairs], dtype=float)
        feats = np.stack(
            [
                np.ones(len(pairs)),
                np.array([c.rows for c, _ in pairs], dtype=float),
                np.array(
                    [c.paged_blocks for c, _ in pairs], dtype=float
                ),
                np.array(
                    [float(c.chunked) for c, _ in pairs], dtype=float
                ),
            ],
            axis=1,
        )
        use = [0] + [j for j in (1, 2, 3) if np.ptp(feats[:, j]) > 0]
        coef, *_ = np.linalg.lstsq(feats[:, use], resid, rcond=None)
        sol = [0.0, 0.0, 0.0, 0.0]
        for j, c in zip(use, coef):
            sol[j] = max(0.0, float(c))
        return cls(*sol)

    def fingerprint(self) -> tuple:
        return (
            round(self.step_overhead_s, 9),
            round(self.per_row_s, 12),
            round(self.per_block_s, 12),
            round(self.chunk_overhead_s, 9),
        )


# ----------------------------------------------------------------- knobs --


@dataclasses.dataclass(frozen=True)
class ServeKnobs:
    """The planned subset of ServeConfig: everything the sweep searches.
    ``ServeConfig.autotune`` maps these onto the nested sub-configs."""

    slots: int
    kv_layout: str = "paged"
    block_size: int = 16
    num_blocks: int | None = None      # paged pool size incl. the sink
    prefill_chunk: int = 0
    token_budget: int | None = None

    def kv_splits(self, max_len: int) -> int:
        """Online-softmax split count of the decode kernel: the paged grid
        splits at physical blocks; the contiguous twin pins its split to
        the same size (KVConfig.decode_block)."""
        return -(-max_len // self.block_size)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeKnobs":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def validate(self, max_len: int) -> None:
        """Eager validation mirroring ServeConfig's own: a cached plan that
        fails here is stale/corrupt and must be re-searched, never served
        (the same defense choose_matmul_tiles applies to tile entries)."""
        if not isinstance(self.slots, int) or self.slots < 1:
            raise ValueError(f"slots must be a positive int: {self.slots!r}")
        if self.kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"bad kv_layout: {self.kv_layout!r}")
        if not isinstance(self.block_size, int) or self.block_size < 1:
            raise ValueError(f"bad block_size: {self.block_size!r}")
        if max_len % self.block_size:
            raise ValueError(
                f"max_len {max_len} not a multiple of block_size "
                f"{self.block_size}"
            )
        if self.kv_layout == "paged":
            if self.num_blocks is not None and (
                not isinstance(self.num_blocks, int) or self.num_blocks < 2
            ):
                raise ValueError(f"bad num_blocks: {self.num_blocks!r}")
        elif self.num_blocks is not None:
            raise ValueError("num_blocks only applies to the paged layout")
        if not isinstance(self.prefill_chunk, int) or self.prefill_chunk < 0:
            raise ValueError(f"bad prefill_chunk: {self.prefill_chunk!r}")
        if self.prefill_chunk and max_len % self.prefill_chunk:
            raise ValueError(
                f"max_len {max_len} not a multiple of prefill_chunk "
                f"{self.prefill_chunk}"
            )
        if self.token_budget is not None:
            if self.prefill_chunk == 0:
                raise ValueError("token_budget requires prefill_chunk > 0")
            if (
                not isinstance(self.token_budget, int)
                or self.token_budget < self.prefill_chunk
            ):
                raise ValueError(f"bad token_budget: {self.token_budget!r}")


@dataclasses.dataclass(frozen=True)
class ServePlanSpace:
    """The swept joint space.  Every combination is enumerated, sized to
    the iso-HBM budget, and priced; infeasible points (on-chip/HBM overflow,
    zero admitted rows) are dropped like any other infeasible mapping."""

    slot_counts: tuple[int, ...] = (2, 4, 8, 16, 32)
    block_sizes: tuple[int, ...] = (8, 16, 32)
    layouts: tuple[str, ...] = ("paged", "contiguous")
    prefill_chunks: tuple[int, ...] = (0, 16, 32)
    # token_budget = multiplier * prefill_chunk (chunks advanced per step);
    # only meaningful for chunked points
    token_budget_chunks: tuple[int, ...] = (1,)

    def fingerprint(self) -> tuple:
        return (
            self.slot_counts, self.block_sizes, self.layouts,
            self.prefill_chunks, self.token_budget_chunks,
        )


# ------------------------------------------------------------- step model --


def decode_gemms(cfg) -> list[tuple[str, int, int, int]]:
    """The per-step GEMM nests of a dense decoder-only transformer:
    (name, N, K, multiplicity).  M is the live row count and comes from the
    schedule, not the model."""
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    up = cfg.d_ff * (2 if cfg.mlp_act == "swiglu" else 1)
    return [
        ("qkv", (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d, L),
        ("attn_out", d, cfg.n_heads * hd, L),
        ("mlp_up", up, d, L),
        ("mlp_down", d, cfg.d_ff, L),
        ("unembed", cfg.vocab, d, 1),
    ]


def _check_dense(cfg) -> None:
    """Refuse what is not a dense decoder-only step with all-global
    attention: MoE and recurrent mixers with the reference's message;
    hybrid, encoder-decoder and local-attention models too, which the
    reference's check lets through (the step model prices none of their
    parts, and the engine refuses the paged layout and the prefill lane for
    sliding windows)."""
    if getattr(cfg, "mixer", "attention") != "attention" or getattr(
        cfg, "moe", None
    ):
        raise ValueError(
            f"the serve planner models dense decoder-only decode steps; "
            f"{cfg.name!r} (mixer={getattr(cfg, 'mixer', '?')!r}, "
            f"moe={getattr(cfg, 'moe', None) is not None}) is out of scope"
        )
    if cfg.family not in ("dense", "vlm") or cfg.sliding_window:
        raise ValueError(
            f"the serve planner models dense decoder-only decode steps; "
            f"{cfg.name!r} (family={cfg.family!r}, "
            f"sliding_window={cfg.sliding_window}) is out of scope"
        )


@dataclasses.dataclass(frozen=True)
class StepCost:
    """One steady-state decode step, before calibration."""

    rows: int            # live decode rows advanced per step
    admitted: int        # concurrency the KV capacity admits
    flops: float         # decode GEMMs + attention + amortized prefill
    hbm_words: float
    smem_words: float    # on-chip words: shared memory (VMEM on the TPU)
    kv_pool_bytes: int
    roofline_s: float    # max(compute, HBM bandwidth) — uncalibrated
    ttft_steps: float    # steps from admission to first token
    paged_blocks: float  # physical blocks gathered per step (0: contiguous)
    chunked: int         # 1 when the chunked prefill lane is armed
    breakdown: dict      # per-term HBM words

    def step_s(self, calib: Calibration) -> float:
        return (
            self.roofline_s
            + calib.step_overhead_s
            + calib.per_row_s * self.rows
            + calib.per_block_s * self.paged_blocks
            + calib.chunk_overhead_s * self.chunked
        )

    def tokens_per_s(self, calib: Calibration) -> float:
        return self.rows / self.step_s(calib)

    def ttft_s(self, calib: Calibration) -> float:
        return self.ttft_steps * self.step_s(calib)

    def energy_pj(self) -> float:
        return en.serve_step_energy_pj(
            macs=self.flops / 2.0,
            hbm_words=self.hbm_words,
            smem_words=self.smem_words,
            smem_bytes=self.breakdown["smem_capacity_bytes"],
        )


def _gemm_hbm_words(hw: ServeHardware, rows: int, N: int, K: int) -> int | None:
    """HBM words of one (rows, K) @ (K, N) decode GEMM, or None when its
    plan does not fit the chip (see the module docstring)."""
    if hw.target == "tpu":
        tiles = choose_matmul_tiles(rows, N, K, vmem_bytes=hw.smem_bytes // 4)
        if tiles.vmem_bytes() > hw.smem_bytes:
            return None
        return tiles.hbm_words(rows, N, K)
    from repro_torch.kernels.matmul import matmul as mm

    plan = mm.plan(rows, N, K)
    if plan.smem > h100.SMEM_PER_BLOCK_BYTES:
        return None
    return K * N * -(-rows // plan.bm) + rows * K + rows * N


def _attention_row_words(
    cfg, hw: ServeHardware, knobs: ServeKnobs, ctx: int, max_len: int, rows: int
) -> float | None:
    """One row's decode-attention gather for one layer, in words, or None
    when the decode kernel's plan does not fit a block (see the module
    docstring)."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    bs = knobs.block_size
    if hw.target == "tpu":
        return float(
            attention_gather_words(
                np.int64(ctx),
                np.int64(bs),
                kv_heads=kv,
                head_dim=hd,
                kv_splits=(
                    None
                    if knobs.kv_layout == "paged"
                    else np.int64(knobs.kv_splits(max_len))
                ),
            )
        )
    from repro_torch.kernels.flash_attention import decode_attention as dec

    G = cfg.n_heads // kv
    plan = dec.plan(rows, kv, G, hd, bs, max_len // bs, WORD_BYTES)
    if dec.smem_bytes(G, hd, bs, WORD_BYTES, plan.ts, plan.nbuf) > h100.SMEM_PER_BLOCK_BYTES:
        return None
    blocks = -(-ctx // bs)
    kv_words = 2 * blocks * bs * kv * hd
    table_words = 2 * blocks if knobs.kv_layout == "paged" else 0  # int32
    # fp32 (two words), each written once and read once
    partial_words = 2 * 2 * dec.workspace_floats(1, kv, G, hd, bs, blocks)
    return float(kv_words + table_words + partial_words)


def price_decode_step(
    cfg,
    knobs: ServeKnobs,
    *,
    max_len: int,
    workload: ServeWorkload,
    hardware: ServeHardware | None = None,
) -> StepCost | None:
    """Price one steady-state decode step under the given knobs, or None
    when the point is infeasible (no admitted rows, or weights + pool
    overflow HBM, or a kernel's plan overflows its shared memory).  See the
    module docstring for the model."""
    _check_dense(cfg)
    hw = hardware or ServeHardware()
    knobs.validate(max_len)
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    ctx = workload.mean_ctx(max_len)
    bs = knobs.block_size
    kv_row_bytes = 2 * cfg.n_kv_heads * hd * WORD_BYTES  # K+V, one token

    # ---- KV capacity: what the layout admits at this context length ----
    if knobs.kv_layout == "paged":
        num_blocks = knobs.num_blocks
        if num_blocks is None:
            # the engine's own default: the contiguous footprint + sink
            num_blocks = knobs.slots * (max_len // bs) + 1
        row_blocks = -(-ctx // bs)
        admitted = (num_blocks - 1) // row_blocks
        kv_pool_bytes = L * num_blocks * bs * kv_row_bytes
    else:
        admitted = knobs.slots
        kv_pool_bytes = L * knobs.slots * max_len * kv_row_bytes
    rows = min(knobs.slots, workload.concurrency, admitted)
    if rows < 1:
        return None
    weight_bytes = cfg.params_count() * WORD_BYTES
    if weight_bytes + kv_pool_bytes > hw.hbm_bytes:
        return None

    # ---- decode GEMMs: traffic off the kernel's plan (TPU: the tiles) ----
    gemm_words = 0.0
    gemm_flops = 0.0
    smem_words = 0.0
    for _name, N, K, mult in decode_gemms(cfg):
        words = _gemm_hbm_words(hw, rows, N, K)
        if words is None:
            return None
        gemm_words += mult * words
        gemm_flops += mult * 2.0 * rows * N * K
        # operand reads feed the MMA from on-chip memory; the output tile
        # writes back
        smem_words += mult * (2.0 * rows * N * K + rows * N)

    # ---- decode attention: gather + partials + this step's KV write ----
    att_row_words = _attention_row_words(cfg, hw, knobs, ctx, max_len, rows)
    if att_row_words is None:
        return None
    att_words = rows * L * (
        att_row_words
        + 2 * cfg.n_heads * hd       # q read + attention output write
        + 2 * cfg.n_kv_heads * hd    # this token's K+V write
    )
    att_flops = rows * L * 4.0 * cfg.n_heads * hd * ctx
    smem_words += att_words  # every gathered word crosses on-chip memory once

    # ---- prefill lane: steady-state admission turnover ----
    # each slot re-admits every decode_len steps, so admission must stream
    # prompt_len * rows / decode_len prefill tokens per step on average
    demand_tok = workload.prompt_len * rows / workload.decode_len
    if knobs.prefill_chunk > 0:
        budget = knobs.token_budget or knobs.prefill_chunk
        lane_tok_per_step = float(budget)
        if lane_tok_per_step < demand_tok:
            # admission-bound: occupancy sags until turnover matches the
            # lane's streaming rate
            rows = max(
                1,
                int(
                    rows * lane_tok_per_step / demand_tok
                ),
            )
            demand_tok = workload.prompt_len * rows / workload.decode_len
        chunks_per_step = max(1, budget // knobs.prefill_chunk)
        ttft_steps = math.ceil(
            math.ceil(workload.prompt_len / knobs.prefill_chunk)
            / chunks_per_step
        ) + 1.0
    else:
        # monolithic: the whole prompt lands in one fused admission step
        ttft_steps = 1.0
    prefill_tok = demand_tok
    # prefill rides the same step program, so weights are already paid by
    # the decode GEMM pass; the lane adds per-token KV writes plus its
    # causal attention reads (each prefill token attends to half the
    # prompt on average) and the matching compute
    prefill_words = prefill_tok * L * 2.0 * cfg.n_kv_heads * hd * (
        1.0 + workload.prompt_len / 2.0
    )
    prefill_flops = prefill_tok * (
        2.0 * cfg.params_count()
        + 4.0 * L * cfg.n_heads * hd * (workload.prompt_len / 2.0)
    )
    smem_words += prefill_words

    # ---- embedding gathers for this step's input tokens ----
    embed_words = (rows + prefill_tok) * d

    hbm_words = gemm_words + att_words + prefill_words + embed_words
    flops = gemm_flops + att_flops + prefill_flops
    smem_lvl, hbm_lvl = hw.levels()
    hbm_words_per_s = (
        hbm_lvl.bandwidth_words_per_cycle * hw.clock_hz
    )
    roofline_s = max(flops / hw.peak_flops, hbm_words / hbm_words_per_s)
    return StepCost(
        rows=rows,
        admitted=int(min(admitted, workload.concurrency)),
        flops=flops,
        hbm_words=hbm_words,
        smem_words=smem_words,
        kv_pool_bytes=kv_pool_bytes,
        roofline_s=roofline_s,
        ttft_steps=ttft_steps,
        paged_blocks=(
            float(rows * -(-ctx // bs))
            if knobs.kv_layout == "paged"
            else 0.0
        ),
        chunked=int(knobs.prefill_chunk > 0),
        breakdown={
            "gemm_words": gemm_words,
            "attention_words": att_words,
            "prefill_words": prefill_words,
            "embed_words": embed_words,
            "smem_capacity_bytes": smem_lvl.capacity_bytes,
        },
    )


# ----------------------------------------------------------------- sweep --


@dataclasses.dataclass(frozen=True)
class ServePoint:
    """One priced serve configuration: attribute names double as
    ``pareto_prune`` keys (minimization in every key)."""

    knobs: ServeKnobs
    cost: StepCost
    us_per_token: float
    ttft_ms: float
    energy_pj_per_token: float


def sweep_serve_space(
    cfg,
    *,
    max_len: int,
    workload: ServeWorkload | None = None,
    hardware: ServeHardware | None = None,
    space: ServePlanSpace | None = None,
    kv_budget_tokens: int | None = None,
    calibration: Calibration | None = None,
) -> list[ServePoint]:
    """Enumerate and price the joint serve-knob space under one iso-HBM KV
    budget.  ``kv_budget_tokens`` defaults to the largest contiguous
    member's footprint (``max(slot_counts) * max_len``), so every candidate
    — paged or contiguous — is compared at equal KV HBM, exactly the
    paper's iso-resource discipline; pass an explicit budget to plan for a
    different pool."""
    _check_dense(cfg)
    hw = hardware or ServeHardware()
    wl = workload or ServeWorkload()
    sp = space or ServePlanSpace()
    calib = calibration or Calibration()
    if kv_budget_tokens is None:
        kv_budget_tokens = max(sp.slot_counts) * max_len
    points: list[ServePoint] = []
    for layout in sp.layouts:
        for bs in sp.block_sizes:
            if max_len % bs:
                continue
            if layout == "paged":
                num_blocks = kv_budget_tokens // bs + 1
                if num_blocks < 2:
                    continue
            else:
                num_blocks = None
            for slots in sp.slot_counts:
                if layout == "contiguous" and slots * max_len > kv_budget_tokens:
                    continue  # iso-HBM: this member overflows the budget
                for chunk in sp.prefill_chunks:
                    if chunk and max_len % chunk:
                        continue
                    budgets = (
                        [m * chunk for m in sp.token_budget_chunks]
                        if chunk
                        else [None]
                    )
                    for budget in budgets:
                        knobs = ServeKnobs(
                            slots=slots,
                            kv_layout=layout,
                            block_size=bs,
                            num_blocks=num_blocks,
                            prefill_chunk=chunk,
                            token_budget=budget,
                        )
                        cost = price_decode_step(
                            cfg, knobs, max_len=max_len, workload=wl,
                            hardware=hw,
                        )
                        if cost is None:
                            continue
                        points.append(
                            ServePoint(
                                knobs=knobs,
                                cost=cost,
                                us_per_token=1e6
                                / cost.tokens_per_s(calib),
                                ttft_ms=1e3 * cost.ttft_s(calib),
                                energy_pj_per_token=cost.energy_pj()
                                / cost.rows,
                            )
                        )
    return points


# ------------------------------------------------------------------ plan --


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """The sweep's winner plus its predicted stats and provenance."""

    knobs: ServeKnobs
    max_len: int
    predicted: dict
    source: str          # "search" | "cache"
    frontier_size: int = 0

    def as_dict(self) -> dict:
        return {
            "knobs": self.knobs.as_dict(),
            "max_len": self.max_len,
            "predicted": self.predicted,
            "frontier_size": self.frontier_size,
        }


def _plan_cache_path() -> str | None:
    path = os.environ.get(_PLAN_CACHE_ENV, _PLAN_CACHE_DEFAULT)
    return path or None


def _model_fingerprint(cfg) -> tuple:
    return (
        cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.d_ff, cfg.vocab, cfg.resolved_head_dim, cfg.mlp_act,
        cfg.tie_embeddings,
    )


def _plan_key(
    cfg, max_len, workload, hardware, space, kv_budget_tokens, calibration
) -> str:
    desc = repr(
        (
            _PLAN_CACHE_SCHEMA,
            _model_fingerprint(cfg),
            max_len,
            workload.fingerprint(),
            hardware.fingerprint(),
            space.fingerprint(),
            kv_budget_tokens,
            calibration.fingerprint(),
        )
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:32]


def _store_plan(path: str, key: str, plan: ServePlan) -> None:
    """Read-merge-replace, like mapper._store_tile: concurrent planners
    lose at most one entry, and the rename keeps the file parseable."""
    data = load_json_dict(path)
    data[key] = plan.as_dict()
    try:
        atomic_write_json(path, data)
    except OSError:
        pass  # cache is best-effort; the plan is still returned


def _load_plan(path: str, key: str, max_len: int) -> ServePlan | None:
    got = load_json_dict(path).get(key)
    if not isinstance(got, dict):
        return None
    try:
        knobs = ServeKnobs.from_dict(got["knobs"])
        knobs.validate(int(got["max_len"]))
        if int(got["max_len"]) != max_len:
            return None
    except (KeyError, TypeError, ValueError):
        return None  # corrupt/stale entry: re-search and overwrite
    return ServePlan(
        knobs=knobs,
        max_len=max_len,
        predicted=dict(got.get("predicted", {})),
        source="cache",
        frontier_size=int(got.get("frontier_size", 0)),
    )


def plan_serve(
    cfg,
    *,
    max_len: int = 256,
    workload: ServeWorkload | None = None,
    hardware: ServeHardware | None = None,
    space: ServePlanSpace | None = None,
    kv_budget_tokens: int | None = None,
    calibration: Calibration | None = None,
    ttft_ceiling_ms: float | None = None,
    cache: bool | str = True,
) -> ServePlan:
    """Sweep the joint serve-knob space and return the winner.

    The objective is predicted decode tokens/sec over the Pareto frontier
    (time-per-token, TTFT, energy-per-token); ``ttft_ceiling_ms`` filters
    the frontier first (the serving analogue of ``best_at_iso_throughput``'s
    throughput constraint — latency held, throughput optimized).  Winners
    persist per (hardware, model, workload, space, budget, calibration) in
    the JSON store named by ``REPRO_TORCH_SERVE_PLAN_CACHE`` (same defense as the
    tile cache: entries are validated before being served, and a corrupt
    entry is re-searched and overwritten).  Pass ``cache=False`` to force a
    fresh search, or a path string to use a specific store."""
    wl = workload or ServeWorkload()
    hw = hardware or ServeHardware()
    sp = space or ServePlanSpace()
    calib = calibration or Calibration()
    if kv_budget_tokens is None:
        kv_budget_tokens = max(sp.slot_counts) * max_len

    path = cache if isinstance(cache, str) else (
        _plan_cache_path() if cache else None
    )
    key = _plan_key(cfg, max_len, wl, hw, sp, kv_budget_tokens, calib)
    if path:
        got = _load_plan(path, key, max_len)
        if got is not None:
            return got

    points = sweep_serve_space(
        cfg, max_len=max_len, workload=wl, hardware=hw, space=sp,
        kv_budget_tokens=kv_budget_tokens, calibration=calib,
    )
    if not points:
        raise ValueError(
            f"no feasible serve configuration for {cfg.name!r} at "
            f"max_len={max_len} under kv_budget_tokens={kv_budget_tokens} "
            f"(every swept point overflowed HBM/VMEM or admitted 0 rows)"
        )
    frontier = pareto_prune(
        points, keys=("us_per_token", "ttft_ms", "energy_pj_per_token")
    )
    eligible = frontier
    if ttft_ceiling_ms is not None:
        ok = [p for p in frontier if p.ttft_ms <= ttft_ceiling_ms]
        if ok:
            eligible = ok  # no eligible point: fall back to the frontier
    best = min(eligible, key=lambda p: (p.us_per_token, p.ttft_ms))
    plan = ServePlan(
        knobs=best.knobs,
        max_len=max_len,
        predicted={
            "tokens_per_s": best.cost.tokens_per_s(calib),
            "us_per_token": best.us_per_token,
            "ttft_ms": best.ttft_ms,
            "energy_pj_per_token": best.energy_pj_per_token,
            "rows": best.cost.rows,
            "admitted": best.cost.admitted,
            "kv_pool_bytes": best.cost.kv_pool_bytes,
            "hbm_words_per_step": best.cost.hbm_words,
            "swept_points": len(points),
        },
        source="search",
        frontier_size=len(frontier),
    )
    if path:
        _store_plan(path, key, plan)
    return plan
