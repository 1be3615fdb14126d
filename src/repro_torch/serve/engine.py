"""Continuous-batching serve engine; port of the main path of
``repro/serve/engine.py``.

The decode batch is a fixed ring of ``batch`` KV slots and requests flow
through it continuously:

  * **admission**: waiting requests are prefilled (grouped by padded
    length; by exact length for RWKV-6, whose recurrent state pad tokens
    would pollute) and scattered into free slots -- or, under the paged
    layout (attention models only), packed into pool blocks with prefix
    sharing and copy-on-write;
  * **decode**: every step advances all slots by one token
    (``Model.decode_step`` -> ``layers.multihead_attention`` -> ragged
    flash-decoding, or ``rwkv.rwkv_mix`` -> the WKV-6 kernel);
  * **eviction + backfill**: a slot frees the moment its request finishes
    and is refilled from the queue on the next step.

Ported: the request lifecycle WAITING -> ACTIVE -> FINISHED with
``cancel`` (CANCELLED) and load shedding (REJECTED: the ``max_waiting``
bound and the stall watchdog), the greedy sampler, the NaN guard, a
temperature sampler of the port's own, the per-block KV checksum audit
(``kv_checksum``), and the silent-data-corruption (SDC) defense
(``KernelConfig.abft``): checksummed decode GEMMs, a sampled attention
fingerprint, a periodic weight scrub, and detect -> retry -> quarantine
(:meth:`Engine._sdc_recover`).  Priorities, preemption and replay,
deadlines, the chunked-prefill lane, recovery, autotuning and
``StaticEngine`` are not ported (ROADMAP queue A): their config fields are
accepted only at their defaults.  The reference's one-shot substrate
fallback is not ported either: a kernel failure raises.

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
    ACTIVE = "ACTIVE"         # holds a slot (and, paged, blocks)
    FINISHED = "FINISHED"     # ran to its token budget
    CANCELLED = "CANCELLED"   # Engine.cancel(); partial tokens kept
    FAILED = "FAILED"         # quarantined by the NaN guard (reason says why)
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
    # per-request sampling seed; None inherits ServeConfig.seed
    seed: int | None = None
    on_token: TokenCallback | None = None
    # not ported (ROADMAP A5): accepted only at their defaults
    priority: int = 0
    deadline_steps: int | None = None

    @property
    def max_new_tokens(self) -> int:
        return self.max_new


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch: int = 4               # number of KV slots (decode batch width)
    # >0: right-pad prompts to a multiple of this so mixed lengths share
    # one prefill shape (global-attention models only)
    prefill_bucket: int = 0
    # the chunked-prefill lane; only 0 (monolithic admission) is ported
    prefill_chunk: int = 0
    # bound the waiting queue: overflow submissions end REJECTED
    max_waiting: int | None = None
    # consecutive idle no-progress steps before the queue head is shed
    stall_patience: int = 64

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch (KV slot count) must be >= 1: {self.batch}")
        if self.prefill_bucket < 0:
            raise ValueError(f"prefill_bucket must be >= 0: {self.prefill_bucket}")
        if self.prefill_chunk != 0:
            raise _not_ported("the chunked-prefill lane (prefill_chunk > 0)", "A5")
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
    snapshot_dir: str | None = None  # not ported (ROADMAP A8)
    # paged only: per-physical-block |K|+|V| sums recomputed every step; a
    # block that changed without a legal write FAILs every request holding
    # it (blocks released).  O(pool) device work per step, off by default.
    kv_checksum: bool = False

    def __post_init__(self):
        if self.snapshot_dir is not None:
            raise _not_ported("crash recovery (snapshot_dir)", "A8")


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

    def resolved_num_blocks(self) -> int:
        if self.kv.num_blocks is not None:
            return self.kv.num_blocks
        return self.scheduler.batch * self.max_len // self.kv.block_size + 1  # + sink


@dataclasses.dataclass
class _ReqInfo:
    rid: int
    prompt: np.ndarray
    budget: int                  # effective max_new_tokens
    seq: int                     # arrival order
    seed: int = 0
    status: RequestStatus = RequestStatus.WAITING
    reason: str = ""
    submitted: int = 0           # engine step count at submit
    ttft: int | None = None
    on_token: TokenCallback | None = None


@dataclasses.dataclass
class _SlotState:
    rid: int
    emitted: int                 # tokens generated so far
    budget: int
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


# checksum-failed steps one request survives (each costs a rewind and a
# re-execution on the plain attention) before it is quarantined as the
# probable corruption source
SDC_RETRY_BUDGET = 2


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
                "continuous batching serves decoder-only LMs; encdec requests "
                "need per-request encoder state"
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
        # decode steps only, not a one-token prompt)
        self._prefill_dispatch = dataclasses.replace(self.dispatch, attention=None)
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
        self._waiting: list[int] = []       # rids in arrival order
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
            "cancelled": 0,
            "rejected": 0,
            "shed": 0,
            "quarantined": 0,
            "sdc_detected": 0,  # abft: steps whose checks flagged
            "sdc_retried": 0,   # abft: re-executions on the plain attention
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
            self._kv_sums = self._pool_sums()

    # ----------------------------------------------------------- sampling --
    def _sample(
        self, logits: torch.Tensor, rids: list[int], ts: list[int]
    ) -> np.ndarray:
        """One token per row: argmax at temperature 0, else Gumbel-max with
        noise from a CPU generator seeded by ``_mix(seed, rid, t)``."""
        temp = self.scfg.temperature
        if temp <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        lf = logits.float().cpu() / temp
        out = np.empty((lf.shape[0],), np.int64)
        for i, (rid, t) in enumerate(zip(rids, ts)):
            g = torch.Generator().manual_seed(_mix(self._reqs[rid].seed, rid, t))
            u = torch.rand(lf.shape[1], generator=g).clamp_(min=1e-20)
            out[i] = int(torch.argmax(lf[i] - torch.log(-torch.log(u))))
        return out

    # ---------------------------------------------------------- admission --
    def submit(self, req: Request) -> int:
        """Queue a request; returns its id.  Prompts longer than
        ``max_len - 1`` keep their most recent tokens; the token budget is
        cut so the request never outgrows its slot.  A full waiting queue
        REJECTs the submission."""
        if req.priority != 0:
            raise _not_ported("request priorities", "A5")
        if req.deadline_steps is not None:
            raise _not_ported("request deadlines", "A5")
        rid = req.request_id if req.request_id is not None else self._next_rid
        if rid in self._reqs:
            raise ValueError(f"duplicate request_id {rid}")
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
            self._waiting.append(rid)
        return rid

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

    def _activate(self, info: _ReqInfo, slot: int, tok: int, on_token) -> None:
        """First-token bookkeeping for a freshly admitted request."""
        self._outputs[info.rid].append(tok)
        info.ttft = self._step_no - info.submitted
        self._cur_tok[slot] = tok
        info.status = RequestStatus.ACTIVE
        # registered BEFORE the callback so a callback may cancel it
        self._slots[slot] = _SlotState(rid=info.rid, emitted=1, budget=info.budget)
        done = info.budget == 1
        self._emit_cbs(info, tok, 0, done, on_token)
        if info.status == RequestStatus.ACTIVE and done:
            self._release_slot(slot)
            self._finish(info, RequestStatus.FINISHED, "")

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
        available, in strict arrival order.  Ownership is committed
        host-side first (prefix match, allocation, chain registration),
        then each group prefills into a contiguous scratch whose private
        blocks are packed into the pool."""
        bs = self.scfg.kv.block_size
        n_blk = self.scfg.max_len // bs
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
                table_row = np.full((n_blk,), kvcache.SINK_BLOCK, np.int32)
                table_row[: len(row.blocks)] = row.blocks
                kvcache.paged_set_row(
                    self.caches, slot, torch.from_numpy(table_row).to(self.device), row.plen
                )
                self._row_len[slot] = row.plen
                n_prompt = -(-row.plen // bs)
                start = row.n_shared_full
                n_pack = n_prompt - start - (1 if row.tail_shared else 0)
                if n_pack > 0:
                    phys = torch.tensor(row.blocks[start : start + n_pack], device=self.device)
                    kvcache.paged_store_row_blocks(self.caches, scratch, j, start, phys)
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
        """Publish this row's prompt blocks in the radix prefix index
        (admission packs them within the same step)."""
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
        for row in self._rows.values():
            for b in row.blocks:
                refs[b] = refs.get(b, 0) + 1
            if row.cow_dst is not None:
                refs[row.cow_dst] = refs.get(row.cow_dst, 0) + 1
        return refs

    # ---------------------------------------------------------- lifecycle --
    def status(self, rid: int) -> RequestStatus:
        info = self._reqs.get(rid)
        return RequestStatus.UNKNOWN if info is None else info.status

    def cancel(self, rid: int, reason: str = "cancelled") -> RequestStatus:
        """Cancel a waiting or active request (idempotent on terminal ones);
        partial tokens stay retrievable via :meth:`pop_result`."""
        info = self._reqs.get(rid)
        if info is None:
            return RequestStatus.UNKNOWN
        if info.status in TERMINAL_STATUSES:
            return info.status
        if info.status == RequestStatus.ACTIVE:
            self._release_slot(next(s for s, st in self._slots.items() if st.rid == rid))
        else:
            self._waiting.remove(rid)
        self.stats["cancelled"] += 1
        self._finish(info, RequestStatus.CANCELLED, reason)
        return RequestStatus.CANCELLED

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
        """Backfill free slots from the queue, then advance every occupied
        slot by one decode token.  Returns False once the engine is idle.
        With ABFT on, a step whose checks flag is retried before anything
        is emitted (:meth:`_sdc_recover`)."""
        if self._abft and self._kv_sums is not None:
            # audit BEFORE decode, against the blocks the PREVIOUS step
            # legally wrote: a KV flip between steps quarantines its owner
            # before the poisoned read, so survivors never see the block
            self._audit_kv_checksums()
        self._step_no += 1
        self._touched = {kvcache.SINK_BLOCK}
        admitted = False
        while self._free and self._waiting:
            if not self._admit_waiting(on_token):
                break  # paged: head of queue waits for free blocks
            admitted = True
        if self._paged:
            self._resolve_cow()
        if not self._slots:
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

        finished = []
        for s in sorted(self._slots):
            st = self._slots.get(s)
            if st is None:
                continue  # an on_token callback cancelled this row mid-loop
            tok = int(nxt[s])
            self._outputs[st.rid].append(tok)
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
        result = RequestResult(info.status, tokens, info.reason, info.ttft)
        if info.status in TERMINAL_STATUSES:
            del self._reqs[rid]
            del self._outputs[rid]
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
