"""Continuous-batching serve engine; port of ``repro/serve/engine.py``
without autotuning.

The decode batch is a fixed ring of ``batch`` KV slots and requests flow
through it continuously:

  * **admission**: waiting requests are prefilled (grouped by padded
    length; by exact length for RWKV-6 and the hybrid family, whose
    recurrent states and KV rings pad tokens would pollute) and scattered
    into free slots -- or, under the paged layout (global-attention models
    only), packed into pool blocks with prefix sharing and copy-on-write.
    With ``prefill_chunk > 0`` one prompt at a time streams through a
    batch-1 scratch cache in fixed chunks instead (the chunked-prefill
    lane, at most ``token_budget`` prompt tokens a step) and is published
    through the same path once complete;
  * **decode**: every step advances all slots by one token
    (``Model.decode_step`` -> ``layers.multihead_attention`` -> ragged
    flash-decoding, ``rwkv.rwkv_mix`` -> the WKV-6 kernel, or
    ``rglru.rglru_block`` -> the linear-scan kernel);
  * **eviction + backfill**: a slot frees the moment its request finishes
    and is refilled from the queue on the next step.

Request lifecycle::

    WAITING -> [PREFILLING ->] ACTIVE -> FINISHED
                 |                |  \\-> CANCELLED | FAILED  (cancel / deadline)
                 \\---------------+--> PREEMPTED -> WAITING  (priority starvation)
    WAITING -> CANCELLED | FAILED | REJECTED         (cancel / deadline / shed)

The queue is ordered by (-priority, arrival).  A starved head (no free
slot, or under the paged layout too few free blocks) preempts the
lowest-priority, youngest active request of strictly lower priority; the
victim re-prefills on re-admission and its already emitted tokens are
*replayed* through the decode step, each re-derived token checked against
the record and not emitted again (:class:`ReplayDivergedError` if one
differs).  Deadlines (``Request.deadline_steps``, in engine steps) FAIL a
request wherever it is, through the eviction path of ``cancel``.
Also ported: load shedding (REJECTED: the ``max_waiting`` bound and the
stall watchdog), the greedy sampler, the NaN guard, a temperature sampler
of the port's own, the per-block KV checksum audit (``kv_checksum``), the
silent-data-corruption (SDC) defense (``KernelConfig.abft``: checksummed
decode GEMMs, a sampled attention fingerprint, a periodic weight scrub,
and detect -> retry -> quarantine, :meth:`Engine._sdc_recover`), and the
static-batch baseline :class:`StaticEngine`, and crash recovery
(``DurabilityConfig.snapshot_dir``: a write-ahead journal and periodic
snapshots, :mod:`repro_torch.serve.recovery`).  Autotuning is not ported
(ROADMAP A6c).  The reference's one-shot substrate fallback is not ported
either: a kernel failure raises.

Replay and the lane are bitwise only if a prefill row's bits do not
depend on the admission's shape.  Admission therefore prefills with
``Dispatch.q_block`` set (attention in fixed pieces, each prompt's head
alone); the projections are row-invariant under ``matmul="pallas"`` on
the card and on the CPU, not under cuBLAS (``matmul="xla"`` on the card).

With ABFT on, admission prefill runs the plain GEMM kernel (``matmul_cuda``)
where the reference runs the checksum kernel and drops its verdict (no
trace is installed at admission): the two kernels' products are bitwise
equal, so the tokens are the same.

Sampling at temperature > 0 draws Gumbel noise from a CPU
``torch.Generator`` seeded from a mix of ``(seed, request id, token
index)``, so a request's tokens do not depend on its slot or on the other
requests in flight.  The draws differ from the reference's ``jax.random``
ones; token parity with the reference is greedy-only.
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.arch import layers as L
from repro_torch.arch.model_zoo import build
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import abft
from repro_torch.serve import kvcache

# on_token(request_id, token, index, done)
TokenCallback = Callable[[int, int, int, bool], None]


class RequestStatus(str, enum.Enum):
    WAITING = "WAITING"       # queued, not yet admitted
    PREFILLING = "PREFILLING"  # in the chunked-prefill lane: holds a slot
    ACTIVE = "ACTIVE"         # holds a slot (and, paged, blocks)
    PREEMPTED = "PREEMPTED"   # evicted mid-generation, queued to replay
    FINISHED = "FINISHED"     # ran to its token budget
    CANCELLED = "CANCELLED"   # Engine.cancel(); partial tokens kept
    FAILED = "FAILED"         # deadline or quarantine (reason says why)
    REJECTED = "REJECTED"     # load-shed: queue bound or watchdog
    UNKNOWN = "UNKNOWN"       # never submitted, or already popped


TERMINAL_STATUSES = frozenset(
    {
        RequestStatus.FINISHED,
        RequestStatus.CANCELLED,
        RequestStatus.FAILED,
        RequestStatus.REJECTED,
    }
)


@dataclasses.dataclass
class RequestResult:
    """Terminal (or, for a live request, current) status plus the
    generated tokens; array-like, as the reference's."""

    status: RequestStatus
    tokens: np.ndarray
    reason: str = ""
    preemptions: int = 0
    # steps from submit to the first emitted token
    ttft_steps: int | None = None

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.tokens, dtype)
        return arr.copy() if copy else arr

    def __len__(self) -> int:
        return len(self.tokens)

    def __iter__(self):
        return iter(self.tokens)

    def __getitem__(self, i):
        return self.tokens[i]

    def tolist(self) -> list[int]:
        return self.tokens.tolist()


@dataclasses.dataclass(frozen=True)
class Request:
    prompt: np.ndarray           # (T,) int32
    max_new: int = 16
    # stable id for deterministic sampling; defaults to submission order
    request_id: int | None = None
    # higher admits first and may preempt strictly lower-priority active
    # requests when admission is slot- or block-starved
    priority: int = 0
    # engine steps the request may live before it FAILs; None = no deadline
    deadline_steps: int | None = None
    # per-request sampling seed; None inherits ServeConfig.seed
    seed: int | None = None
    on_token: TokenCallback | None = None

    @property
    def max_new_tokens(self) -> int:
        return self.max_new


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch: int = 4               # number of KV slots (decode batch width)
    # >0: right-pad prompts to a multiple of this so mixed lengths share
    # one prefill shape (global-attention models only)
    prefill_bucket: int = 0
    # >0: prompts stream through a batch-1 scratch lane in chunks of this
    # many tokens, interleaved with decode steps; 0 = monolithic admission,
    # the lane's bitwise oracle
    prefill_chunk: int = 0
    # chunked only: prompt tokens advanced per step (token_budget //
    # prefill_chunk chunks); None = unlimited
    token_budget: int | None = None
    # bound the waiting queue: overflow submissions end REJECTED
    max_waiting: int | None = None
    # consecutive idle no-progress steps before the queue head is shed
    stall_patience: int = 64
    # False: pure FIFO -- no priority order, no preemption, no lane takeover
    priorities: bool = True

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch (KV slot count) must be >= 1: {self.batch}")
        if self.prefill_bucket < 0:
            raise ValueError(f"prefill_bucket must be >= 0: {self.prefill_bucket}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = monolithic admission): {self.prefill_chunk}"
            )
        if self.token_budget is not None:
            if self.prefill_chunk == 0:
                raise ValueError(
                    f"token_budget={self.token_budget} only takes effect with "
                    f"chunked prefill; set prefill_chunk > 0 or drop token_budget"
                )
            if self.token_budget < self.prefill_chunk:
                raise ValueError(
                    f"token_budget ({self.token_budget}) must cover at least one "
                    f"prefill_chunk ({self.prefill_chunk}) per step, or admission "
                    f"livelocks"
                )
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1 or None: {self.max_waiting}")
        if self.stall_patience < 1:
            raise ValueError(f"stall_patience must be >= 1: {self.stall_patience}")


@dataclasses.dataclass(frozen=True)
class KVConfig:
    # "contiguous": one (slots, max_len) ring per layer; "paged": a
    # refcounted block pool + per-row block tables (kvcache.BlockPool)
    layout: str = "contiguous"
    block_size: int = 16         # paged: tokens per physical block
    # paged: pool size per layer including the sink; None sizes it to the
    # contiguous footprint (batch * max_len tokens) plus the sink
    num_blocks: int | None = None
    prefix_sharing: bool = True  # paged: radix prefix index + CoW
    # pin the contiguous decode KV split; equal to the paged block size it
    # makes the two layouts' reductions identical, hence bitwise comparable
    decode_block: int | None = None

    def __post_init__(self):
        if self.layout not in ("contiguous", "paged"):
            raise ValueError(f"kv layout must be 'contiguous' or 'paged': {self.layout!r}")
        if self.decode_block is not None and self.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1: {self.decode_block}")
        if self.layout == "paged":
            if self.block_size < 1:
                raise ValueError(f"block_size must be >= 1: {self.block_size}")
            if self.num_blocks is not None and self.num_blocks < 2:
                raise ValueError(
                    f"num_blocks counts the sink block too, so it must be >= 2: "
                    f"{self.num_blocks}"
                )
            if self.decode_block is not None and self.decode_block != self.block_size:
                raise ValueError(
                    f"the paged layout splits decode attention at block_size="
                    f"{self.block_size}; decode_block={self.decode_block} contradicts it"
                )
        elif self.num_blocks is not None:
            raise ValueError("num_blocks only applies to the paged layout")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    # "xla": torch.matmul projections; "pallas": the hand-written GEMM
    matmul: str = "xla"
    # "flash": ragged decode-attention kernel; "xla": masked dense oracle
    # (contiguous) or the plain paged version (paged)
    attention: str = "flash"
    # "off" | "checksum" | "paranoid": SDC defense of the decode step
    # (kernels/abft.py).  "checksum" column-checksums every projection GEMM
    # and fingerprints 4 sampled rows of each paged decode-attention output;
    # "paranoid" fingerprints every row.  Paged layout only.  Served tokens
    # are bitwise those of "off".
    abft: str = "off"
    # decode steps between full weight-fingerprint passes (abft only): a
    # weight flip is caught at the next scrub, up to N-1 steps after it
    # lands; compute and KV faults are caught on the step they strike
    scrub_every: int = 1

    def __post_init__(self):
        if self.matmul not in ("xla", "pallas"):
            raise ValueError(f"matmul must be 'xla' or 'pallas': {self.matmul!r}")
        if self.attention not in ("flash", "xla"):
            raise ValueError(f"attention must be 'flash' or 'xla': {self.attention!r}")
        if self.abft not in ("off", "checksum", "paranoid"):
            raise ValueError(
                f"abft must be 'off', 'checksum' or 'paranoid': {self.abft!r}"
            )
        if not isinstance(self.scrub_every, int) or self.scrub_every < 1:
            raise ValueError(f"scrub_every must be a positive int: {self.scrub_every!r}")


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    # per-step NaN/Inf guard on decode logits: a non-finite row is
    # quarantined (FAILED, blocks released) instead of streaming garbage
    guard_nan: bool = True
    # a directory here arms the RecoveryManager (serve/recovery.py): a
    # crc32'd write-ahead journal of submits, cancels, pops and token deltas
    # (committed every step) plus a snapshot of the whole serving state every
    # ``snapshot_every`` steps, staged at the step boundary and published
    # by a background thread with one rename; restore_engine() rebuilds a
    # crashed engine whose requests finish bitwise as if it never crashed
    snapshot_dir: str | None = None
    snapshot_every: int = 32
    snapshot_keep: int = 3           # published snapshots kept by GC
    # fsync the journal every N per-step commits (submit, cancel and pop
    # always sync); 1 = every step
    journal_fsync_every: int = 1
    # paged only: per-physical-block |K|+|V| sums recomputed every step; a
    # block that changed without a legal write FAILs every request holding
    # it (blocks released).  O(pool) device work per step, off by default.
    kv_checksum: bool = False

    def __post_init__(self):
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1 step: {self.snapshot_every}")
        if self.snapshot_keep < 1:
            raise ValueError(f"snapshot_keep must be >= 1 snapshot: {self.snapshot_keep}")
        if self.journal_fsync_every < 1:
            raise ValueError(
                f"journal_fsync_every must be >= 1 commit: {self.journal_fsync_every}"
            )


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0
    seed: int = 0
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    kv: KVConfig = dataclasses.field(default_factory=KVConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    durability: DurabilityConfig = dataclasses.field(default_factory=DurabilityConfig)

    def __post_init__(self):
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2: {self.max_len}")
        if self.durability.kv_checksum and self.kv.layout != "paged":
            raise ValueError(
                "kv_checksum tracks per-physical-block sums, which only "
                "exist under the paged layout"
            )
        if self.kernel.abft != "off" and self.kv.layout != "paged":
            raise ValueError(
                "abft localizes corruption through the paged pool's "
                "per-block fingerprints and the plain paged attention; "
                "set KVConfig(layout='paged') (or abft='off')"
            )
        if self.kv.layout == "paged" and self.max_len % self.kv.block_size:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of block_size "
                f"{self.kv.block_size}"
            )
        chunk = self.scheduler.prefill_chunk
        if chunk > 0 and self.max_len % chunk:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of prefill_chunk {chunk} "
                f"so the final chunk's right-padding never overflows the scratch lane"
            )

    def resolved_num_blocks(self) -> int:
        if self.kv.num_blocks is not None:
            return self.kv.num_blocks
        return self.scheduler.batch * self.max_len // self.kv.block_size + 1  # + sink


@dataclasses.dataclass
class _ReqInfo:
    rid: int
    prompt: np.ndarray
    budget: int                  # effective max_new_tokens
    priority: int
    deadline: int | None         # absolute engine step, or None
    seq: int                     # arrival order (FIFO tie-break in a priority)
    status: RequestStatus = RequestStatus.WAITING
    reason: str = ""
    preemptions: int = 0
    seed: int = 0
    submitted: int = 0           # engine step count at submit
    ttft: int | None = None
    on_token: TokenCallback | None = None


@dataclasses.dataclass
class _SlotState:
    rid: int
    emitted: int                 # tokens generated so far (this occupancy)
    budget: int
    # preemption recovery: tokens already emitted before eviction; while
    # emitted < replay the decode step re-derives the recorded tokens
    # (checked bitwise) without emitting them again
    replay: int = 0
    # abft: checksum-failed steps survived while this request was live
    # (quarantined once it reaches SDC_RETRY_BUDGET)
    sdc_retries: int = 0


@dataclasses.dataclass
class _PagedRow:
    """Block ownership of one live paged request (host side)."""

    blocks: list[int]            # logical block -> physical
    plen: int                    # prompt tokens
    n_shared_full: int           # leading full blocks aliased via the index
    tail_shared: bool            # partial prompt tail aliased (CoW pending)
    cow_dst: int | None          # pre-allocated CoW target for the tail


@dataclasses.dataclass
class _PrefillLane:
    """One chunked prefill in flight: the PREFILLING request holds a slot
    (and, paged, its blocks) while its prompt streams through the batch-1
    scratch cache.  Nothing reaches the shared KV before install, so
    dropping a lane needs no device write."""

    rid: int
    slot: int
    filled: int = 0               # prompt tokens already through the scratch
    row: _PagedRow | None = None  # paged ownership (registered at install)


def _mix(seed: int, rid: int, t: int) -> int:
    """A 63-bit generator seed from (seed, request id, token index)
    (splitmix64 finalizer over a polynomial mix)."""
    x = (seed * 0x9E3779B97F4A7C15 + rid * 0xBF58476D1CE4E5B9 + t * 0x94D049BB133111EB)
    x &= (1 << 64) - 1
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x >> 1


def sample_rows(
    logits: torch.Tensor, temperature: float, keys: list[tuple[int, int, int]]
) -> np.ndarray:
    """One token per row of ``logits``: argmax at temperature 0, else
    Gumbel-max with noise from a CPU generator seeded by ``_mix(seed, rid,
    t)`` for the row's ``(seed, rid, t)`` in ``keys``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).cpu().numpy()
    lf = logits.float().cpu() / temperature
    out = np.empty((lf.shape[0],), np.int64)
    for i, (seed, rid, t) in enumerate(keys):
        g = torch.Generator().manual_seed(_mix(seed, rid, t))
        u = torch.rand(lf.shape[1], generator=g).clamp_(min=1e-20)
        out[i] = int(torch.argmax(lf[i] - torch.log(-torch.log(u))))
    return out


# queries a piece of the admission prefill's attention holds
# (``Dispatch.q_block``): every prefill row then runs at one shape
PREFILL_Q_BLOCK = 128


# checksum-failed steps one request survives (each costs a rewind and a
# re-execution on the plain attention) before it is quarantined as the
# probable corruption source
SDC_RETRY_BUDGET = 2


class ReplayDivergedError(RuntimeError):
    """A preempted request's replay re-derived another token than the one
    it emitted before eviction: the prefill or decode arithmetic depends on
    the admission's shape or the slot.  Raised before anything is emitted."""

    def __init__(self, rid: int, index: int, got: int, recorded: int, where: str):
        super().__init__(
            f"request {rid}: recovery {where} diverged at token {index} "
            f"({got} != recorded {recorded})"
        )
        self.rid, self.index, self.got, self.recorded = rid, index, got, recorded


class SDCUnlocalizedError(RuntimeError):
    """A detected silent data corruption could not be pinned to one
    request: the retry on the plain attention still failed its checksums,
    or the weight fingerprint changed.  Raised BEFORE the step's tokens are
    emitted, so no corrupt token leaves the engine."""


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when no
    card is visible rather than running on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Engine:
    """Continuous-batching engine over ``Model.prefill``/``decode_step``.

    ``device`` defaults to ``cuda``; with no visible card the constructor
    raises.  Parameters are moved to the device once."""

    def __init__(
        self, cfg: ModelConfig, params: Any, scfg: ServeConfig, device=None
    ):
        if cfg.family == "encdec":
            raise ValueError(
                "continuous batching serves decoder-only LMs; whisper-style "
                "encdec requests need per-request encoder state"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build(cfg)
        self.params = _to_device(params, self.device)
        self.scfg = scfg
        kv = scfg.kv
        self.dispatch = L.Dispatch(
            matmul=scfg.kernel.matmul,
            attention="flash" if scfg.kernel.attention == "flash" else None,
            decode_block=kv.decode_block,
        )
        # admission prefill runs the masked dense attention, as the
        # reference's admission programs do (the decode kernel serves Tq == 1
        # decode steps only, not a one-token prompt), in fixed-shape pieces
        # so a row's bits are the same in any admission (a group, a lone
        # re-prefill, a chunk of the lane)
        self._prefill_dispatch = dataclasses.replace(
            self.dispatch, attention=None, q_block=PREFILL_Q_BLOCK
        )
        self._paged = kv.layout == "paged"
        B = scfg.scheduler.batch
        if self._paged:
            if not kvcache.supports_paged(cfg):
                raise ValueError(
                    f"kv layout 'paged' needs all-global attention; {cfg.name} "
                    f"has ring/recurrent/hybrid caches"
                )
            nb = scfg.resolved_num_blocks()
            self.caches = kvcache.build_paged_caches(
                cfg, B, scfg.max_len, nb, kv.block_size, self.device
            )
            self.pool = kvcache.BlockPool(nb, kv.block_size)
            self._axes = None
            self._sink_row = torch.zeros(
                (scfg.max_len // kv.block_size,), dtype=torch.int32, device=self.device
            )
            # host mirror of every row's device length (rows that hold no
            # request keep growing one a step, as on the device)
            self._row_len = np.zeros((B,), np.int64)
        else:
            self.caches = kvcache.build_caches(cfg, B, scfg.max_len, self.device)
            self.pool = None
            self._axes = kvcache.slot_axes(cfg, scfg.max_len)
        self._free: deque[int] = deque(range(B))
        # waiting rids sorted by (-priority, seq): head = best request; a
        # preempted request keeps its seq, so it re-enters ahead of later
        # arrivals of its priority
        self._waiting: list[int] = []
        self._reqs: dict[int, _ReqInfo] = {}
        self._slots: dict[int, _SlotState] = {}
        self._rows: dict[int, _PagedRow] = {}
        self._outputs: dict[int, list[int]] = {}
        self._next_rid = 0
        self._next_seq = 0
        self._step_no = 0
        self._stalled = 0
        self._cur_tok = np.zeros((B,), np.int64)
        self.stats = {
            "peak_active": 0,
            "admitted": 0,
            "preempted": 0,
            "recovered": 0,     # preempted requests re-admitted
            "replayed": 0,      # tokens re-derived (not emitted) by replay
            "cancelled": 0,
            "expired": 0,
            "rejected": 0,
            "shed": 0,
            "quarantined": 0,
            "sdc_detected": 0,  # abft: steps whose checks flagged
            "sdc_retried": 0,   # abft: re-executions on the plain attention
            "snapshots": 0,     # recovery snapshots staged
        }

        # ---- abft state (kernels/abft.py) ----
        self._abft = scfg.kernel.abft if scfg.kernel.abft != "off" else None
        # the one-shot SDC injection point for the next decode step
        self._fault = abft.no_fault()
        self._abft_probe: dict[str, int] = {}  # check sites of one step
        self._wsums0 = self._colstats = None
        if self._abft:
            # weight fingerprint baselined once: checksums cannot see weight
            # flips, so scrub steps re-reduce and compare exactly
            self._wsums0 = abft.weight_sums(self.params)
            # static per-column |w| bounds for the checksum tolerance
            self._colstats = abft.weight_colstats(self.params)
        # per-physical-block |K|+|V| sums, mirrored on the host and compared
        # every step against the blocks legally written; abft arms them too,
        # to localize KV flips between steps
        self._kv_sums: np.ndarray | None = None
        self._touched: set[int] = set()
        if scfg.durability.kv_checksum or (self._abft and self._paged):
            self._refresh_kv_sums()

        # ---- the chunked-prefill lane (prefill_chunk > 0) ----
        # Prompts stream through a batch-1 contiguous scratch cache in fixed
        # (1, prefill_chunk) chunks whose positions continue from the
        # scratch's len cursor; install publishes through the monolithic
        # admission path, so prefill_chunk=0 is the lane's bitwise oracle.
        self._chunk = scfg.scheduler.prefill_chunk
        self._lane: _PrefillLane | None = None
        self._scratch: dict | None = None
        if self._chunk and not kvcache.supports_padded_prefill(cfg):
            raise ValueError(
                f"prefill_chunk needs all-global attention (positions derive from "
                f"the cache cursor and the final chunk is right-padded); {cfg.name} "
                f"has ring/recurrent/hybrid caches -- use monolithic admission "
                f"(prefill_chunk=0)"
            )

        # crash consistency: journal + periodic snapshots (serve/recovery.py)
        self.recovery = None
        dur = scfg.durability
        if dur.snapshot_dir:
            from repro_torch.serve.recovery import RecoveryManager

            RecoveryManager.attach(
                self, dur.snapshot_dir, every=dur.snapshot_every,
                keep=dur.snapshot_keep, fsync_every=dur.journal_fsync_every,
            )

    # ----------------------------------------------------------- sampling --
    def _sample(
        self, logits: torch.Tensor, rids: list[int], ts: list[int]
    ) -> np.ndarray:
        """One token per row (:func:`sample_rows`) under each request's
        seed."""
        keys = [(self._reqs[rid].seed, rid, t) for rid, t in zip(rids, ts)]
        return sample_rows(logits, self.scfg.temperature, keys)

    # ---------------------------------------------------------- admission --
    def submit(self, req: Request) -> int:
        """Queue a request; returns its id.  Prompts longer than
        ``max_len - 1`` keep their most recent tokens; the token budget is
        cut so the request never outgrows its slot.  A full waiting queue
        REJECTs the submission."""
        rid = req.request_id if req.request_id is not None else self._next_rid
        if rid in self._reqs:
            raise ValueError(f"duplicate request_id {rid}")
        if req.deadline_steps is not None and req.deadline_steps < 0:
            raise ValueError(
                f"request {rid}: deadline_steps must be >= 0: {req.deadline_steps}"
            )
        self._next_rid = max(self._next_rid, rid + 1)
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        max_len = self.scfg.max_len
        if len(prompt) >= max_len:
            prompt = prompt[-(max_len - 1) :]
        budget = min(int(req.max_new_tokens), max_len - len(prompt))
        if self._paged:
            cap_tokens = (self.pool.num_blocks - 1) * self.scfg.kv.block_size
            if len(prompt) + budget > cap_tokens:
                raise ValueError(
                    f"request {rid} needs {len(prompt) + budget} KV tokens but "
                    f"the whole pool holds {cap_tokens}"
                )
        info = _ReqInfo(
            rid=rid,
            prompt=prompt,
            budget=budget,
            priority=int(req.priority),
            deadline=(
                None if req.deadline_steps is None
                else self._step_no + int(req.deadline_steps)
            ),
            seq=self._next_seq,
            seed=self.scfg.seed if req.seed is None else int(req.seed),
            submitted=self._step_no,
            on_token=req.on_token,
        )
        self._next_seq += 1
        self._reqs[rid] = info
        self._outputs[rid] = []
        mw = self.scfg.scheduler.max_waiting
        if budget <= 0 or len(prompt) == 0:
            self._finish(info, RequestStatus.FINISHED, "empty prompt or budget")
        elif mw is not None and len(self._waiting) >= mw:
            self.stats["rejected"] += 1
            self._finish(info, RequestStatus.REJECTED, f"queue full (max_waiting={mw})")
        else:
            self._enqueue(info)
        if self.recovery is not None:
            # journaled once the outcome is known: the record carries a
            # terminal-at-submit status too, so replay needs no re-validation
            self.recovery.record_submit(info)
        return rid

    def _enqueue(self, info: _ReqInfo) -> None:
        """Insert into the queue at (-priority, arrival), or at arrival
        alone with ``priorities=False``."""
        if self.scfg.scheduler.priorities:
            key = lambda r: (-self._reqs[r].priority, self._reqs[r].seq)  # noqa: E731
        else:
            key = lambda r: self._reqs[r].seq  # noqa: E731
        bisect.insort(self._waiting, info.rid, key=key)

    @staticmethod
    def _finish(info: _ReqInfo, status: RequestStatus, reason: str) -> None:
        info.status = status
        info.reason = reason

    def _bucket_len(self, plen: int) -> int:
        bucket = self.scfg.scheduler.prefill_bucket
        if not kvcache.supports_padded_prefill(self.cfg):
            bucket = 0
        lpad = -(-plen // bucket) * bucket if bucket > 0 else plen
        return plen if lpad > self.scfg.max_len else lpad

    def _activate(self, info: _ReqInfo, slot: int, tok: int, on_token) -> bool:
        """First-token bookkeeping for an admitted request; returns True
        when it stays active.  A recovering (preempted) request emits
        nothing: its recorded first token must re-derive bitwise."""
        out = self._outputs[info.rid]
        replay = len(out)
        if replay:
            if tok != out[0]:
                raise ReplayDivergedError(info.rid, 0, tok, out[0], "re-prefill")
            self.stats["recovered"] += 1
        else:
            out.append(tok)
            if info.ttft is None:
                info.ttft = self._step_no - info.submitted
        self._cur_tok[slot] = tok
        info.status = RequestStatus.ACTIVE
        # registered BEFORE the callback so a callback may cancel it
        self._slots[slot] = _SlotState(
            rid=info.rid, emitted=1, budget=info.budget, replay=replay
        )
        done = info.budget == 1
        if not replay:
            self._emit_cbs(info, tok, 0, done, on_token)
        if info.status != RequestStatus.ACTIVE:
            return False  # the callback ended it; its slot is released
        if done:
            self._release_slot(slot)
            self._finish(info, RequestStatus.FINISHED, "")
            return False
        return True

    @staticmethod
    def _emit_cbs(info: _ReqInfo, tok: int, idx: int, done: bool, on_token) -> None:
        if info.on_token is not None:
            info.on_token(info.rid, tok, idx, done)
        if on_token is not None:
            on_token(info.rid, tok, idx, done)

    def _prompt_batch(self, lpad: int, infos: list[_ReqInfo]):
        """Right-pad one admission group's prompts into an (n, lpad) token
        batch plus per-row true lengths, on the device."""
        toks = np.zeros((len(infos), lpad), np.int32)
        for j, info in enumerate(infos):
            toks[j, : len(info.prompt)] = info.prompt
        tlens = np.asarray([len(i.prompt) for i in infos], np.int32)
        return (
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(tlens).to(self.device),
        )

    def _prefill(self, infos: list[_ReqInfo], lpad: int):
        """Prefill one group into a fresh contiguous cache and sample each
        request's first token (t = 0)."""
        toks, tlens = self._prompt_batch(lpad, infos)
        small = kvcache.build_caches(self.cfg, len(infos), self.scfg.max_len, self.device)
        logits, small = self.model.prefill(
            self.params, toks, small, last_index=tlens - 1,
            dispatch=self._prefill_dispatch,
        )
        first = self._sample(logits, [i.rid for i in infos], [0] * len(infos))
        return first, small, tlens

    def _admit_waiting(self, on_token: TokenCallback | None) -> bool:
        """Backfill every free slot from the queue; admissions sharing a
        padded length prefill as one batch.  Returns True when anything
        was admitted."""
        if self._paged:
            return self._admit_waiting_paged(on_token)
        groups: dict[int, list[tuple[_ReqInfo, int]]] = {}
        while self._free and self._waiting:
            info = self._reqs[self._waiting.pop(0)]
            slot = self._free.popleft()
            groups.setdefault(self._bucket_len(len(info.prompt)), []).append((info, slot))
        for lpad, items in groups.items():
            first, small, tlens = self._prefill([it[0] for it in items], lpad)
            kvcache.mask_prompt_tail(small, tlens)
            for j, (_, slot) in enumerate(items):
                kvcache.slot_store(
                    self.caches, kvcache.take_slot(small, j, self._axes), slot, self._axes
                )
            self.stats["admitted"] += len(items)
            for j, (info, slot) in enumerate(items):
                self._activate(info, slot, int(first[j]), on_token)
        self.stats["peak_active"] = max(self.stats["peak_active"], len(self._slots))
        return bool(groups)

    # ------------------------------------------------------ paged admission --
    def _admit_waiting_paged(self, on_token: TokenCallback | None) -> bool:
        """A request enters when a slot AND enough free blocks are
        available, in strict queue order (the head is never jumped).
        Ownership is committed host-side first (prefix match, allocation,
        chain registration), then each group prefills into a contiguous
        scratch whose private blocks are packed into the pool."""
        groups: dict[int, list[tuple[_ReqInfo, int, _PagedRow]]] = {}
        while self._free and self._waiting:
            info = self._reqs[self._waiting[0]]
            row = self._commit_row(info)
            if row is None:
                break  # head of line waits for completions to free blocks
            self._waiting.pop(0)
            slot = self._free.popleft()
            self._register_chain(info, row)
            self._rows[slot] = row
            if self._kv_sums is not None:
                # admission packs (or aliases) these blocks this step;
                # marking aliased ones is a harmless over-approximation
                self._touched.update(row.blocks)
            groups.setdefault(self._bucket_len(row.plen), []).append((info, slot, row))

        for lpad, items in groups.items():
            first, scratch, _ = self._prefill([it[0] for it in items], lpad)
            self.stats["admitted"] += len(items)
            for j, (info, slot, row) in enumerate(items):
                self._publish_paged(slot, row, scratch, j)
                self._activate(info, slot, int(first[j]), on_token)
        self.stats["peak_active"] = max(self.stats["peak_active"], len(self._slots))
        return bool(groups)

    def _commit_row(self, info: _ReqInfo) -> _PagedRow | None:
        """Host-side block ownership for one paged admission: retain prefix
        aliases, allocate the rest, reserve the CoW target.  None when the
        pool cannot satisfy the request now; nothing is committed then."""
        bs = self.scfg.kv.block_size
        plen = len(info.prompt)
        total = -(-(plen + info.budget) // bs)
        shared_full: list[int] = []
        shared_tail = None
        if self.scfg.kv.prefix_sharing:
            shared_full, shared_tail = self.pool.match_prefix(info.prompt.tolist())
        n_shared = len(shared_full) + (1 if shared_tail is not None else 0)
        cow_needed = shared_tail is not None and info.budget > 1
        if total - n_shared + (1 if cow_needed else 0) > self.pool.free_blocks:
            return None
        for b in shared_full:
            self.pool.retain(b)
        if shared_tail is not None:
            self.pool.retain(shared_tail)
        blocks = list(shared_full)
        if shared_tail is not None:
            blocks.append(shared_tail)
        while len(blocks) < total:
            blocks.append(self.pool.alloc())
        return _PagedRow(
            blocks=blocks,
            plen=plen,
            n_shared_full=len(shared_full),
            tail_shared=shared_tail is not None,
            cow_dst=self.pool.alloc() if cow_needed else None,
        )

    def _register_chain(self, info: _ReqInfo, row: _PagedRow) -> None:
        """Publish this row's prompt blocks in the radix prefix index.
        Monolithic admission does this at commit (it packs within the same
        step); the lane at install, since a block whose K/V is not packed
        yet must never be aliased."""
        if not self.scfg.kv.prefix_sharing:
            return
        bs = self.scfg.kv.block_size
        toks = info.prompt.tolist()
        n_full = row.plen // bs
        prev = -1
        for i in range(n_full):
            self.pool.register(prev, tuple(toks[i * bs : (i + 1) * bs]), row.blocks[i])
            prev = row.blocks[i]
        tail = tuple(toks[n_full * bs :])
        if tail and n_full < len(row.blocks):
            self.pool.register(prev, tail, row.blocks[n_full])

    # ----------------------------------------------- chunked prefill lane --
    def _publish_paged(self, slot: int, row: _PagedRow, scratch: dict, j: int) -> None:
        """Aim ``slot``'s device table at ``row``'s blocks and pack row
        ``j`` of a prefilled contiguous ``scratch`` into its private prompt
        blocks (aliased prefix blocks and a shared tail are skipped)."""
        bs = self.scfg.kv.block_size
        table_row = np.full((self.scfg.max_len // bs,), kvcache.SINK_BLOCK, np.int32)
        table_row[: len(row.blocks)] = row.blocks
        kvcache.paged_set_row(
            self.caches, slot, torch.from_numpy(table_row).to(self.device), row.plen
        )
        self._row_len[slot] = row.plen
        start = row.n_shared_full
        n_pack = -(-row.plen // bs) - start - (1 if row.tail_shared else 0)
        if n_pack > 0:
            phys = torch.tensor(row.blocks[start : start + n_pack], device=self.device)
            kvcache.paged_store_row_blocks(self.caches, scratch, j, start, phys)

    def _start_lane(self) -> bool:
        """Claim the queue head for the lane: reserve a slot (and, paged,
        commit its blocks) and mark it PREFILLING.  False when nothing can
        start (empty queue, no free slot, or a block-starved pool)."""
        if self._lane is not None or not self._waiting or not self._free:
            return False
        info = self._reqs[self._waiting[0]]
        row = None
        if self._paged:
            row = self._commit_row(info)
            if row is None:
                return False
        self._waiting.pop(0)
        slot = self._free.popleft()
        info.status = RequestStatus.PREFILLING
        self._scratch = kvcache.build_caches(self.cfg, 1, self.scfg.max_len, self.device)
        self._lane = _PrefillLane(rid=info.rid, slot=slot, row=row)
        return True

    def _advance_lane(self) -> tuple[bool, int | None]:
        """Run ONE fixed-shape chunk of the lane's prompt through the
        scratch; only the final chunk is right-padded, so the len cursor
        that positions derive from never overshoots mid-prompt.  Returns
        (done, first token): the final chunk samples the request's first
        token (t = 0) at the prompt's last row."""
        lane = self._lane
        info = self._reqs[lane.rid]
        C = self._chunk
        plen = len(info.prompt)
        end = min(plen, lane.filled + C)
        toks = np.zeros((1, C), np.int32)
        toks[0, : end - lane.filled] = info.prompt[lane.filled : end]
        li = torch.tensor([min(C - 1, max(0, plen - 1 - lane.filled))], device=self.device)
        logits, self._scratch = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self._scratch,
            last_index=li, dispatch=self._prefill_dispatch, from_cursor=True,
        )
        lane.filled = end
        if end < plen:
            return False, None
        return True, int(self._sample(logits, [info.rid], [0])[0])

    def _install_lane(self, tok0: int, on_token: TokenCallback | None) -> None:
        """Publish a completed lane through the monolithic admission path
        (tail mask + slot store, or paged table + block pack), register the
        paged chain, and activate the request with its first token."""
        lane = self._lane
        self._lane = None
        info = self._reqs[lane.rid]
        if self._paged:
            row = lane.row
            self._publish_paged(lane.slot, row, self._scratch, 0)
            self._register_chain(info, row)
            self._rows[lane.slot] = row
            if self._kv_sums is not None:
                self._touched.update(row.blocks)
        else:
            tl = torch.tensor([len(info.prompt)], dtype=torch.int32, device=self.device)
            kvcache.mask_prompt_tail(self._scratch, tl)
            kvcache.slot_store(
                self.caches, kvcache.take_slot(self._scratch, 0, self._axes),
                lane.slot, self._axes,
            )
        self._scratch = None
        self.stats["admitted"] += 1
        self._activate(info, lane.slot, tok0, on_token)
        self.stats["peak_active"] = max(self.stats["peak_active"], len(self._slots))

    def _drop_lane(self) -> None:
        """Release a lane in flight: nothing was published, so the slot and
        any committed blocks simply return to their free pools."""
        lane = self._lane
        self._lane = None
        self._scratch = None
        if lane.row is not None:
            for b in lane.row.blocks:
                self.pool.release(b)
            if lane.row.cow_dst is not None:
                self.pool.release(lane.row.cow_dst)
        self._free.append(lane.slot)

    def _preempt_lane(self) -> None:
        """A higher-priority arrival takes the lane between chunks; the
        victim requeues PREEMPTED at its arrival position.  It has emitted
        nothing, so its recovery is a plain re-prefill."""
        info = self._reqs[self._lane.rid]
        self._drop_lane()
        info.status = RequestStatus.PREEMPTED
        info.preemptions += 1
        self.stats["preempted"] += 1
        self._enqueue(info)

    def _schedule_chunks(self, on_token: TokenCallback | None) -> bool:
        """The lane's admission: advance up to ``token_budget //
        prefill_chunk`` chunks this step (unlimited without a budget),
        starting, installing and -- priorities on -- handing the lane to a
        higher-priority head at chunk boundaries.  True on any progress."""
        progressed = False
        budget = self.scfg.scheduler.token_budget
        chunks_left = None if budget is None else budget // self._chunk
        while chunks_left is None or chunks_left > 0:
            if (
                self._lane is not None
                and self._waiting
                and self.scfg.scheduler.priorities
                and self._reqs[self._waiting[0]].priority
                > self._reqs[self._lane.rid].priority
            ):
                self._preempt_lane()
                progressed = True
            if self._lane is None and not self._start_lane():
                break
            done, tok0 = self._advance_lane()
            progressed = True
            if chunks_left is not None:
                chunks_left -= 1
            if done:
                self._install_lane(tok0, on_token)
        return progressed

    def _resolve_cow(self) -> None:
        """Before rows write: give every slot still aliasing a shared
        prompt-tail block its pre-reserved private copy."""
        for slot in sorted(self._slots):
            row = self._rows.get(slot)
            if row is None or row.cow_dst is None:
                continue
            lb = row.plen // self.scfg.kv.block_size
            src = row.blocks[lb]
            kvcache.paged_copy_block(self.caches, slot, lb, src, row.cow_dst)
            self.pool.release(src)
            if self._kv_sums is not None:
                self._touched.add(row.cow_dst)
            row.blocks[lb] = row.cow_dst
            row.cow_dst = None
            row.tail_shared = False

    def _evict_paged(self, slot: int) -> None:
        """Release a row: aim its device table at the sink and return every
        owned block, including a pending CoW reservation, to the pool."""
        row = self._rows.pop(slot)
        kvcache.paged_set_row(self.caches, slot, self._sink_row, 0)
        self._row_len[slot] = 0
        for b in row.blocks:
            self.pool.release(b)
        if row.cow_dst is not None:
            self.pool.release(row.cow_dst)

    def _release_slot(self, slot: int) -> None:
        del self._slots[slot]
        if self._paged:
            self._evict_paged(slot)
        self._free.append(slot)

    def live_block_refs(self) -> dict[int, int]:
        """Physical block -> references implied by live rows (what the
        pool's refcounts must mirror)."""
        refs: dict[int, int] = {}
        rows = list(self._rows.values())
        if self._lane is not None and self._lane.row is not None:
            rows.append(self._lane.row)  # a lane's ownership commits at start
        for row in rows:
            for b in row.blocks:
                refs[b] = refs.get(b, 0) + 1
            if row.cow_dst is not None:
                refs[row.cow_dst] = refs.get(row.cow_dst, 0) + 1
        return refs

    # ---------------------------------------------------------- lifecycle --
    def status(self, rid: int) -> RequestStatus:
        info = self._reqs.get(rid)
        return RequestStatus.UNKNOWN if info is None else info.status

    def _slot_of(self, rid: int) -> int:
        return next(s for s, st in self._slots.items() if st.rid == rid)

    def cancel(self, rid: int, reason: str = "cancelled") -> RequestStatus:
        """Cancel a request in any live state: dequeue it (waiting or
        preempted), drop its lane (prefilling) or evict it (active).
        Idempotent on terminal ones; partial tokens stay retrievable via
        :meth:`pop_result`."""
        info = self._reqs.get(rid)
        if info is None:
            return RequestStatus.UNKNOWN
        if info.status in TERMINAL_STATUSES:
            return info.status
        if info.status == RequestStatus.ACTIVE:
            self._release_slot(self._slot_of(rid))
        elif info.status == RequestStatus.PREFILLING:
            self._drop_lane()
        else:
            self._waiting.remove(rid)
        self.stats["cancelled"] += 1
        self._finish(info, RequestStatus.CANCELLED, reason)
        if self.recovery is not None:
            self.recovery.record_cancel(rid, reason)
        return RequestStatus.CANCELLED

    def preempt(self, rid: int) -> bool:
        """Evict an ACTIVE (or PREFILLING) request and requeue it PREEMPTED
        at its arrival position.  On re-admission its prompt re-prefills
        (through the prefix index, paged) and its emitted tokens replay
        through the decode step, so its output is bitwise the uninterrupted
        run's.  False for a request in any other state."""
        info = self._reqs.get(rid)
        if info is None:
            return False
        if info.status == RequestStatus.PREFILLING:
            self._preempt_lane()
            return True
        if info.status != RequestStatus.ACTIVE:
            return False
        self._release_slot(self._slot_of(rid))
        info.status = RequestStatus.PREEMPTED
        info.preemptions += 1
        self.stats["preempted"] += 1
        self._enqueue(info)
        return True

    def _expire_deadlines(self) -> None:
        """FAIL every request past its deadline -- waiting, prefilling or
        active -- through the eviction path of :meth:`cancel`."""
        now = self._step_no

        def late(rid: int) -> bool:
            deadline = self._reqs[rid].deadline
            return deadline is not None and now > deadline

        for rid in [r for r in self._waiting if late(r)]:
            self._waiting.remove(rid)
            self.stats["expired"] += 1
            self._finish(self._reqs[rid], RequestStatus.FAILED, "deadline expired in queue")
        if self._lane is not None and late(self._lane.rid):
            info = self._reqs[self._lane.rid]
            self._drop_lane()
            self.stats["expired"] += 1
            self._finish(info, RequestStatus.FAILED, "deadline expired while prefilling")
        for slot in [s for s, st in sorted(self._slots.items()) if late(st.rid)]:
            info = self._reqs[self._slots[slot].rid]
            self._release_slot(slot)
            self.stats["expired"] += 1
            self._finish(info, RequestStatus.FAILED, "deadline expired while active")

    def _blocks_needed(self, info: _ReqInfo) -> int:
        """Free blocks the paged admission of ``info`` would take right now:
        the arithmetic :meth:`_commit_row` commits."""
        bs = self.scfg.kv.block_size
        total = -(-(len(info.prompt) + info.budget) // bs)
        if not self.scfg.kv.prefix_sharing:
            return total
        shared_full, shared_tail = self.pool.match_prefix(info.prompt.tolist())
        n_shared = len(shared_full) + (1 if shared_tail is not None else 0)
        cow = shared_tail is not None and info.budget > 1
        return total - n_shared + (1 if cow else 0)

    def _preempt_pass(self) -> None:
        """While the queue head is starved (no free slot, or paged too few
        free blocks) and a request of strictly lower priority is active,
        preempt the worst one (lowest priority, then youngest).  A victim
        whose blocks stay shared frees less than hoped: that costs replay
        time, never correctness."""
        while self._waiting:
            head = self._reqs[self._waiting[0]]
            starved = not self._free or (
                self._paged and self._blocks_needed(head) > self.pool.free_blocks
            )
            if not starved:
                return
            victims = sorted(
                (self._reqs[st.rid].priority, -self._reqs[st.rid].seq, st.rid)
                for st in self._slots.values()
                if self._reqs[st.rid].priority < head.priority
            )
            if not victims:
                return
            self.preempt(victims[0][2])

    def _quarantine(self, slot: int, reason: str) -> None:
        info = self._reqs[self._slots[slot].rid]
        self._release_slot(slot)
        self.stats["quarantined"] += 1
        self._finish(info, RequestStatus.FAILED, reason)

    # ----------------------------------------------------------------- sdc --
    def _pool_sums(self) -> np.ndarray:
        """Per-physical-block |K| + |V| sums over every layer (fp32)."""
        def per_block(pool):
            return torch.sum(torch.abs(pool), dim=(0, 2, 3, 4), dtype=torch.float32)

        return (per_block(self.caches["kpool"]) + per_block(self.caches["vpool"])).cpu().numpy()

    def _refresh_kv_sums(self) -> None:
        """(Re)baseline the per-block sums from the device pools: at init
        and after a snapshot restore."""
        self._kv_sums = self._pool_sums()

    def _audit_kv_checksums(self) -> None:
        """Recompute the per-block sums and compare them with the last
        step's.  A block that changed without a legal write this step
        (``self._touched``) is corrupt: every request holding it is
        quarantined.  NaN sums compare equal to themselves here, so a
        poisoned block that was already quarantined does not fire again."""
        sums = self._pool_sums()
        prev = self._kv_sums
        changed = (sums != prev) & ~(np.isnan(sums) & np.isnan(prev))
        if self._touched:
            changed[list(self._touched)] = False
        prefix = "sdc: " if self._abft else ""
        for b in np.nonzero(changed)[0]:
            b = int(b)
            owners = [s for s, row in self._rows.items() if b in row.blocks or row.cow_dst == b]
            for s in owners:
                if s in self._slots:
                    self._quarantine(
                        s, f"{prefix}KV corruption: block {b} checksum changed without a write"
                    )
        self._kv_sums = sums

    def arm_fault(
        self, site: int, call_idx: int, row: int, col: int, bit: int, layer: int = -1
    ) -> None:
        """Arm the one-shot SDC injection for the next decode step (see
        kernels/abft.py for the site codes, ``col == -1`` targeting the
        row's largest element, and ``layer``: -1 aims at the unembed GEMM
        outside the layer loop).  It is cleared after the faulty pass, so
        the retry models a transient flip and runs clean."""
        if not self._abft:
            raise ValueError(
                "arm_fault needs the abft pipeline: set "
                "KernelConfig.abft='checksum' (or 'paranoid')"
            )
        self._fault = np.array([site, call_idx, row, col, bit, layer, 0, 0], np.int32)

    def _decode_abft(self, toks: torch.Tensor, fault: np.ndarray, attention):
        """One checked decode pass: (logits, flags), ``flags`` a 0-d int32
        device tensor, bit 0 = a checksum or fingerprint failed, bit 1 = the
        weight fingerprint changed (scrub steps only)."""
        B = self.scfg.scheduler.batch
        bs = self.scfg.kv.block_size
        cap = self.scfg.max_len
        # the fingerprinted rows' live splits after this step's write,
        # known on the host: the plain recomputation reads nothing back
        lens = np.clip(self._row_len[abft.sample_rows(B, self._abft)] + 1, 1, cap)
        trace = abft.AbftTrace(
            self._abft, fault, self._colstats, live_splits=int(-(-lens.max() // bs))
        )
        dispatch = dataclasses.replace(self.dispatch, attention=attention, trace=trace)
        logits, self.caches = self.model.decode_step(
            self.params, toks, self.caches, dispatch=dispatch
        )
        self._abft_probe.update(mms=trace.mm_calls, attns=trace.attn_calls)
        flags = trace.any_bad(self.device).to(torch.int32)
        if fault[abft.FAULT_SCRUB]:
            w_bad = torch.any(abft.weight_sums(self.params) != self._wsums0)
            flags = flags | (w_bad.to(torch.int32) << 1)
        return logits, flags

    def _flags_and_guard(self, logits: torch.Tensor, flags: torch.Tensor):
        """The step's verdict and its NaN-guard rows in one device-to-host
        transfer: (flags as int, per-live-row non-finite list)."""
        live = sorted(self._slots)
        nonfinite = ~torch.isfinite(logits[live].float()).all(dim=-1)
        host = torch.cat([flags.reshape(1), nonfinite.to(torch.int32)]).cpu().tolist()
        return host[0], [bool(b) for b in host[1:]]

    def _decode_checked(self, toks: torch.Tensor):
        """The ABFT decode: run the checked pass with this step's fault
        operand (the scrub flag set on the ``scrub_every`` cadence), then
        detect and recover.  Returns (logits, NaN-guard rows)."""
        fault = self._fault.copy()
        fault[abft.FAULT_SCRUB] = self._step_no % self.scfg.kernel.scrub_every == 0
        self._fault = abft.no_fault()  # transient: one shot
        logits, flags = self._decode_abft(toks, fault, self.dispatch.attention)
        f, bad = self._flags_and_guard(logits, flags)
        if f:
            logits, bad = self._sdc_recover(f, toks)
        return logits, bad

    def _sdc_recover(self, flags: int, toks: torch.Tensor):
        """Detect -> localize -> retry.  Rewind every row's length by one
        and re-execute the step on the plain paged attention (the
        reference's oracle substrate) with the fault disarmed: KV writes
        land at positions that depend on lengths and tables only, so the
        retry overwrites whatever the faulty pass wrote.  A retry that still
        fails, or any weight-fingerprint mismatch, cannot be localized:
        raise before anything is emitted."""
        self.stats["sdc_detected"] += 1
        if flags & 2:
            raise SDCUnlocalizedError(
                "weight fingerprint mismatch: parameter corruption cannot be "
                "retried away; restart the engine with freshly loaded params"
            )
        # a step-level checksum cannot name the victim row, so every live
        # request is charged one retry; repeat offenders are quarantined as
        # the probable corruption source before the re-execution
        for s in sorted(self._slots):
            if self._slots[s].sdc_retries >= SDC_RETRY_BUDGET:
                self._quarantine(s, "sdc: retry budget exhausted")
            else:
                self._slots[s].sdc_retries += 1
        # rows quarantined just now sit at length 0; they write to the sink
        # either way, so their rewind stops at 0.  (The host mirror
        # ``_row_len`` advances only after the step, so it needs no rewind.)
        self.caches["len"].sub_(1).clamp_(min=0)
        self.stats["sdc_retried"] += 1
        # disarmed, but scrubbing: the retry must rule out weight corruption
        # before its verdict is trusted, whatever the scrub cadence
        retry = abft.no_fault()
        retry[abft.FAULT_SCRUB] = 1
        logits, flags2 = self._decode_abft(toks, retry, None)
        f, bad = self._flags_and_guard(logits, flags2)
        if f:
            raise SDCUnlocalizedError(
                "checksum failure persisted across the retry on the plain "
                "attention: the corruption cannot be localized"
            )
        return logits, bad

    # -------------------------------------------------------------- drive --
    def step(self, on_token: TokenCallback | None = None) -> bool:
        """One engine iteration: expire deadlines, preempt for a starved
        higher-priority head, backfill free slots from the queue (or run
        the lane's chunks), then advance every occupied slot by one decode
        token.  Returns False once the engine is idle.  With ABFT on, a
        step whose checks flag is retried before anything is emitted
        (:meth:`_sdc_recover`).  With a RecoveryManager attached, the
        step's emitted tokens are journaled (and a snapshot staged on its
        cadence) before the step returns: the end of every step is the
        durability boundary."""
        alive = self._step_core(on_token)
        if self.recovery is not None:
            self.recovery.after_step()
        return alive

    def _step_core(self, on_token: TokenCallback | None) -> bool:
        if self._abft and self._kv_sums is not None:
            # audit BEFORE decode, against the blocks the PREVIOUS step
            # legally wrote: a KV flip between steps quarantines its owner
            # before the poisoned read, so survivors never see the block
            self._audit_kv_checksums()
        self._step_no += 1
        self._touched = {kvcache.SINK_BLOCK}
        self._expire_deadlines()
        if self.scfg.scheduler.priorities:
            self._preempt_pass()
        admitted = False
        if self._chunk:
            admitted = self._schedule_chunks(on_token)
        else:
            while self._free and self._waiting:
                if not self._admit_waiting(on_token):
                    break  # paged: head of queue waits for free blocks
                admitted = True
        if self._paged:
            self._resolve_cow()
        if not self._slots:
            if self._lane is not None:
                # a prefill in flight is progress: decode has nothing to do
                self._stalled = 0
                return True
            if not self._waiting:
                self._stalled = 0
                return False
            if admitted:
                self._stalled = 0  # budget-1 admissions finished instantly
            else:
                # zero active slots, zero admissions, a non-empty queue:
                # nothing inside the engine can free capacity
                self._stalled += 1
                if self._stalled >= self.scfg.scheduler.stall_patience:
                    info = self._reqs[self._waiting.pop(0)]
                    self.stats["shed"] += 1
                    self._finish(
                        info, RequestStatus.REJECTED,
                        f"shed by watchdog: no admission progress in "
                        f"{self._stalled} idle steps",
                    )
                    self._stalled = 0
            return bool(self._waiting)
        self._stalled = 0

        if self._kv_sums is not None:
            # the one block each live row legally appends to this step
            # (decode writes KV at position plen + emitted - 1)
            bs = self.scfg.kv.block_size
            for s, st in self._slots.items():
                row = self._rows[s]
                self._touched.add(row.blocks[(row.plen + st.emitted - 1) // bs])
        toks = torch.from_numpy(self._cur_tok[:, None]).to(self.device)
        bad = None
        if self._abft:
            logits, bad = self._decode_checked(toks)
        else:
            logits, self.caches = self.model.decode_step(
                self.params, toks, self.caches, dispatch=self.dispatch
            )
        if self._paged:
            self._row_len += 1
        live = sorted(self._slots)
        nxt = self._cur_tok.copy()
        nxt[live] = self._sample(
            logits[live],
            [self._slots[s].rid for s in live],
            [self._slots[s].emitted for s in live],
        )
        self._cur_tok = nxt
        if self.scfg.durability.guard_nan:
            if bad is None:
                bad = (~torch.isfinite(logits[live].float()).all(dim=-1)).cpu().tolist()
            # quarantine BEFORE emission: a poisoned row's token is garbage
            for s in [s for s, b in zip(live, bad) if b]:
                self._quarantine(s, "non-finite logits: KV/activation corruption")

        # preemption recovery: a replayed row's token must re-derive the one
        # it emitted before eviction; checked before this step emits anything
        for s, st in sorted(self._slots.items()):
            if st.emitted < st.replay:
                rec = self._outputs[st.rid][st.emitted]
                if int(nxt[s]) != rec:
                    raise ReplayDivergedError(st.rid, st.emitted, int(nxt[s]), rec, "replay")
        finished = []
        for s in sorted(self._slots):
            st = self._slots.get(s)
            if st is None:
                continue  # an on_token callback cancelled this row mid-loop
            tok = int(nxt[s])
            out = self._outputs[st.rid]
            if st.emitted < st.replay:
                st.emitted += 1  # re-derived above; not emitted again
                self.stats["replayed"] += 1
                if st.emitted >= st.budget:
                    finished.append((s, st.rid))
                continue
            out.append(tok)
            st.emitted += 1
            done = st.emitted >= st.budget
            self._emit_cbs(self._reqs[st.rid], tok, st.emitted - 1, done, on_token)
            if done:
                finished.append((s, st.rid))
        for s, rid in finished:
            st = self._slots.get(s)
            if st is None or st.rid != rid:
                continue  # the done-callback already cancelled it
            self._release_slot(s)
            self._finish(self._reqs[rid], RequestStatus.FINISHED, "")
        if self._kv_sums is not None and not self._abft:
            self._audit_kv_checksums()
        return True

    def pop_result(self, rid: int) -> RequestResult:
        """Take a request's result; terminal requests are consumed (their
        id becomes reusable), live ones are a non-consuming snapshot."""
        info = self._reqs.get(rid)
        if info is None:
            return RequestResult(
                RequestStatus.UNKNOWN, np.zeros((0,), np.int32),
                reason="request id never submitted (or already popped)",
            )
        tokens = np.asarray(self._outputs[rid], np.int32)
        result = RequestResult(info.status, tokens, info.reason, info.preemptions, info.ttft)
        if info.status in TERMINAL_STATUSES:
            del self._reqs[rid]
            del self._outputs[rid]
            if self.recovery is not None:
                self.recovery.record_pop(rid)
        return result

    def run(
        self, requests: list[Request] = (), on_token: TokenCallback | None = None
    ) -> list[RequestResult]:
        """Submit ``requests``, drive the engine dry, and return each
        request's result in submission order."""
        rids = [self.submit(r) for r in requests]
        while self.step(on_token):
            pass
        return [self.pop_result(r) for r in rids]

    def close(self) -> None:
        """Flush and close the recovery journal (idempotent; nothing to do
        without durability).  A simulated crash skips this on purpose:
        every journal record is already on disk at the end of its step."""
        if self.recovery is not None:
            self.recovery.close()
            self.recovery = None

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StaticEngine:
    """The static-batch baseline: requests are packed into fixed batches
    of ``batch``, left-padded to the batch's longest prompt and decoded in
    lockstep to its largest budget.  It prefills and decodes through the
    same :class:`~repro_torch.arch.layers.Dispatch` as :class:`Engine` (the
    GEMM and decode-attention kernels), so an A/B of the two measures
    scheduling, not kernels.  Greedy tokens equal the engine's where no
    prompt is padded; at temperature > 0 it samples with the port's
    counter-based sampler per (seed, request id, token index)."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig, device=None):
        if scfg.kv.layout != "contiguous":
            raise ValueError(
                "StaticEngine serves the contiguous layout only (fixed lockstep "
                "batches have no block pool); use Engine for the paged layout"
            )
        if scfg.durability.snapshot_dir:
            raise ValueError(
                "StaticEngine keeps no request state to snapshot; crash "
                "recovery (snapshot_dir) needs the continuous Engine"
            )
        if cfg.family == "encdec":
            raise ValueError("StaticEngine serves decoder-only LMs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build(cfg)
        self.params = _to_device(params, self.device)
        self.scfg = scfg
        self.dispatch = L.Dispatch(
            matmul=scfg.kernel.matmul,
            attention="flash" if scfg.kernel.attention == "flash" else None,
            decode_block=scfg.kv.decode_block,
        )
        self._prefill_dispatch = dataclasses.replace(
            self.dispatch, attention=None, q_block=PREFILL_Q_BLOCK
        )

    def _generate_batch(
        self, requests: list[Request], rids: list[int], on_token: TokenCallback | None
    ) -> list[np.ndarray]:
        scfg = self.scfg
        B = scfg.scheduler.batch
        plen = max(len(r.prompt) for r in requests)
        prompts = np.zeros((B, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i, plen - len(r.prompt) :] = r.prompt  # left-pad
        max_new = max(r.max_new_tokens for r in requests)
        seeds = [scfg.seed if r.seed is None else int(r.seed) for r in requests]
        seeds += [scfg.seed] * (B - len(requests))
        ids = list(rids) + [-1] * (B - len(requests))

        def sample(logits, t):
            keys = [(sd, rid, t) for sd, rid in zip(seeds, ids)]
            return sample_rows(logits, scfg.temperature, keys)

        caches = self.model.init_caches(B, scfg.max_len, self.device)
        logits, caches = self.model.prefill(
            self.params, torch.from_numpy(prompts).to(self.device), caches,
            dispatch=self._prefill_dispatch,
        )
        outs = [sample(logits, 0)]
        self._emit(requests, rids, outs, on_token)
        for t in range(1, max_new):
            tok = torch.from_numpy(outs[-1][:, None]).to(self.device)
            logits, caches = self.model.decode_step(
                self.params, tok, caches, dispatch=self.dispatch
            )
            outs.append(sample(logits, t))
            self._emit(requests, rids, outs, on_token)
        gen = np.stack(outs, axis=1).astype(np.int32)  # (B, max_new)
        return [gen[i, : r.max_new_tokens] for i, r in enumerate(requests)]

    @staticmethod
    def _emit(requests, rids, outs, on_token) -> None:
        if on_token is None:
            return
        t = len(outs) - 1
        for i, r in enumerate(requests):
            if t < r.max_new_tokens:
                on_token(rids[i], int(outs[-1][i]), t, t == r.max_new_tokens - 1)

    def generate(
        self, requests: list[Request], on_token: TokenCallback | None = None
    ) -> list[np.ndarray]:
        """Serve in fixed batches of ``scheduler.batch`` requests; one token
        array per request, in order."""
        results: list[np.ndarray] = []
        B = self.scfg.scheduler.batch
        for lo in range(0, len(requests), B):
            chunk = requests[lo : lo + B]
            rids = [
                r.request_id if r.request_id is not None else lo + i
                for i, r in enumerate(chunk)
            ]
            results.extend(self._generate_batch(chunk, rids, on_token))
        return results
