"""Crash-consistent serving: engine snapshots and a write-ahead journal;
port of ``repro/serve/recovery.py``.

A process crash loses the paged block pools, the radix prefix index and
every request in flight.  Two things make that state durable:

  * an **atomic snapshot**, staged to host memory at a step boundary (a
    blocking device-to-host copy of every cache tensor, so the staged bits
    are the step's even though the engine writes its caches in place from
    the next step on), written by a background thread as ``state.npz``
    plus a sha256'd ``manifest.json`` into a tmp directory and published
    with one ``os.rename``: a crash mid-write never harms the newest
    published snapshot;
  * the **teacher-forced replay** of preemption recovery: decode is
    deterministic and sampling folds ``(seed, rid, t)`` only, so recorded
    tokens re-derive bitwise after a restart, each checked before the step
    emits anything.

Durability contract
-------------------

A snapshot (``snap_<gen>_<step>/``) holds the whole serving state at a
step boundary: every cache tensor, ``_cur_tok``, the waiting queue, each
request's bookkeeping (prompt, budget, priority, absolute deadline,
arrival seq, status, sampling seed, recorded tokens), slot states with
their replay counters, paged row ownership and the whole
:class:`~repro_torch.serve.kvcache.BlockPool` (refcounts, free list,
external holds, the prefix index).  The cache tensors are stored in the
order of :func:`cache_leaves`: depth first, each dict's keys sorted, None
subtrees skipped (``jax.tree_util``'s order for dicts, so the leaf names
``cache_0000`` ... line up with the reference's where the trees do).  A
snapshot whose npz fails its sha256 is quarantined (renamed ``*.corrupt``)
and recovery falls back to the next older one, or to a cold journal-only
replay.

The **write-ahead journal** (``wal_<gen>_<step>.jsonl``, one line per
record: ``b"%08x %s\\n"``, the crc32 of the JSON body, then the body)
records what happened between snapshots: submits (the rebuilt request
fields, the absolute deadline), cancels, result pops and each step's
emitted tokens.  It is flushed every step, fsync'd every
``journal_fsync_every`` steps and at every submit, cancel and pop, and
rotates at each snapshot, so

    recovery = newest valid snapshot
             + every journal segment at or after it, in (gen, step) order.

Requests ACTIVE at the snapshot resume decoding from the restored caches;
requests admitted after it re-prefill; both replay their journaled tokens.
A torn final line (a crash mid-write) fails its crc and is dropped, with
anything after it.

Not durable: tokens after the last fsync'd record, external
``BlockPool.reserve`` holds (their holder died with the process, so
restore releases them), ``on_token`` delivery (replayed tokens are not
streamed again), and, as in the reference, a request's preemption count
and a slot's SDC retry count (``_ReqInfo.preemptions``,
``_SlotState.sdc_retries``): a restored request starts them at 0.

Generations: every restart takes ``gen`` = the largest on disk + 1, so a
restored engine's names never collide with its ancestors' and sort after
them; its anchor snapshot, taken at restore, folds the replayed tail into
the new generation, which is what lets a crash during recovery recover.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import zlib
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _from_savable, _to_savable, dtype_name
from repro_torch.serve.engine import (
    TERMINAL_STATUSES,
    Engine,
    RequestStatus,
    ServeConfig,
    _PagedRow,
    _ReqInfo,
    _SlotState,
)
from repro_torch.serve.kvcache import BlockPool

_FORMAT = 1


class CorruptSnapshot(Exception):
    """A published snapshot failed integrity verification."""


# ------------------------------------------------------------- disk names --
def _snap_name(gen: int, step: int) -> str:
    return f"snap_{gen:04d}_{step:08d}"


def _wal_name(gen: int, step: int) -> str:
    return f"wal_{gen:04d}_{step:08d}.jsonl"


def _parse_key(name: str, prefix: str) -> tuple[int, int] | None:
    """(gen, step) from a snapshot or segment name; None for foreign files
    (tmp directories, quarantined snapshots, strays)."""
    parts = name[len(prefix) :].removesuffix(".jsonl").split("_")
    if len(parts) != 2:
        return None
    try:
        return int(parts[0]), int(parts[1])
    except ValueError:
        return None


def _snapshot_keys(directory: str) -> list[tuple[int, int]]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("snap_") and not name.endswith((".tmp", ".corrupt")):
            key = _parse_key(name, "snap_")
            if key is not None and os.path.isdir(os.path.join(directory, name)):
                out.append(key)
    return sorted(out)


def _segment_keys(directory: str) -> list[tuple[int, int]]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("wal_") and name.endswith(".jsonl"):
            key = _parse_key(name, "wal_")
            if key is not None:
                out.append(key)
    return sorted(out)


def _disk_generations(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return [g for g, _ in _snapshot_keys(directory) + _segment_keys(directory)]


# ---------------------------------------------------------------- journal --
class Journal:
    """Append-only crc32-per-line JSON log.  ``append`` buffers; ``commit``
    flushes and, every ``fsync_every`` commits, fsyncs; ``commit(force=
    True)`` always syncs (submit, cancel and pop, so what a client saw is
    never lost to a crash)."""

    def __init__(self, path: str, fsync_every: int = 1):
        self.path = path
        self._f = open(path, "ab")
        self._fsync_every = max(1, int(fsync_every))
        self._commits_since_sync = 0
        self._dirty = False

    def append(self, rec: dict) -> None:
        body = json.dumps(rec, separators=(",", ":")).encode()
        self._f.write(b"%08x %s\n" % (zlib.crc32(body), body))
        self._dirty = True

    def commit(self, force: bool = False) -> None:
        if not self._dirty and not force:
            return
        self._f.flush()
        self._commits_since_sync += 1
        if force or self._commits_since_sync >= self._fsync_every:
            os.fsync(self._f.fileno())
            self._commits_since_sync = 0
        self._dirty = False

    def close(self) -> None:
        self.commit(force=True)
        self._f.close()


def read_journal(path: str) -> tuple[list[dict], int]:
    """Parse one segment: (records, torn lines).  Reading stops at the
    first line whose crc or JSON fails: a crash mid-append tears only the
    final line, and nothing after a torn line is trustworthy."""
    recs: list[dict] = []
    torn = 0
    with open(path, "rb") as f:
        raw = f.read()
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            crc, body = line.split(b" ", 1)
            if int(crc, 16) != zlib.crc32(body):
                raise ValueError("crc mismatch")
            recs.append(json.loads(body))
        except Exception:
            torn += 1
            break
    return recs, torn


def _submit_record(info: _ReqInfo) -> dict:
    # absolute deadline, effective budget and original seq: replay rebuilds
    # _ReqInfo directly instead of re-running submit()'s validation against
    # another _step_no
    return {
        "t": "submit",
        "rid": info.rid,
        "prompt": [int(t) for t in info.prompt],
        "budget": info.budget,
        "priority": info.priority,
        "deadline": info.deadline,
        "seq": info.seq,
        "status": info.status.value,
        "reason": info.reason,
        "seed": info.seed,
        "submitted": info.submitted,
        "ttft": info.ttft,
    }


def _req_info(rec: dict, default_seed: int) -> _ReqInfo:
    """A request's bookkeeping from its submit record (or a snapshot's)."""
    ttft = rec.get("ttft")
    return _ReqInfo(
        rid=int(rec["rid"]),
        prompt=np.asarray(rec["prompt"], np.int32),
        budget=int(rec["budget"]),
        priority=int(rec["priority"]),
        deadline=None if rec["deadline"] is None else int(rec["deadline"]),
        seq=int(rec["seq"]),
        status=RequestStatus(rec["status"]),
        reason=rec.get("reason", ""),
        seed=int(rec.get("seed", default_seed)),
        submitted=int(rec.get("submitted", 0)),
        ttft=None if ttft is None else int(ttft),
    )


# ----------------------------------------------------------- snapshotting --
def _scfg_fingerprint(scfg: ServeConfig) -> dict:
    """The config fields a snapshot's tensor shapes and bitwise token
    stream depend on, under the reference's names; restore refuses a
    mismatch."""
    sched, kv, kern = scfg.scheduler, scfg.kv, scfg.kernel
    return {
        "batch": sched.batch,
        "max_len": scfg.max_len,
        "temperature": scfg.temperature,
        "seed": scfg.seed,
        "prefill_bucket": sched.prefill_bucket,
        "matmul": kern.matmul,
        "attention": kern.attention,
        "kv_layout": kv.layout,
        "block_size": kv.block_size,
        "num_blocks": scfg.resolved_num_blocks() if kv.layout == "paged" else None,
        "prefix_sharing": kv.prefix_sharing,
        "decode_block": kv.decode_block,
    }


def cache_leaves(caches) -> list[torch.Tensor]:
    """The cache tree's tensors in the snapshot's order: depth first, each
    dict's keys sorted, None subtrees skipped."""
    if caches is None:
        return []
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in cache_leaves(caches[k])]
    return [caches]


def _host_state(eng: Engine) -> dict:
    """JSON-safe, deep-copied host bookkeeping: the background writer sees
    a frozen image while the engine steps on.

    A chunked-prefill lane in flight is stored as its request REQUEUED
    (WAITING, slot freed, committed blocks released in the stored pool
    image): the lane has published nothing (no token, no device table or
    slot write), so restore is a plain re-prefill, bitwise the same."""
    free = list(eng._free)
    waiting = list(eng._waiting)
    pool_state = eng.pool.to_state() if eng.pool is not None else None
    requeued: set[int] = set()
    lane = eng._lane
    if lane is not None:
        free.append(lane.slot)
        waiting = sorted(
            waiting + [lane.rid],
            key=lambda r: (-eng._reqs[r].priority, eng._reqs[r].seq),
        )
        requeued.add(lane.rid)
        if pool_state is not None and lane.row is not None:
            pool = BlockPool.from_state(pool_state)
            for b in lane.row.blocks:
                pool.release(b)
            if lane.row.cow_dst is not None:
                pool.release(lane.row.cow_dst)
            pool_state = pool.to_state()
    reqs = []
    for info in eng._reqs.values():
        rec = _submit_record(info)
        if info.rid in requeued:
            rec["status"] = RequestStatus.WAITING.value
        reqs.append(rec)
    return {
        "step_no": eng._step_no,
        "next_rid": eng._next_rid,
        "next_seq": eng._next_seq,
        "stalled": eng._stalled,
        "stats": dict(eng.stats),
        "free": free,
        "waiting": waiting,
        "reqs": reqs,
        "outputs": {str(rid): list(out) for rid, out in eng._outputs.items()},
        "slots": {
            str(s): {"rid": st.rid, "emitted": st.emitted, "budget": st.budget,
                     "replay": st.replay}
            for s, st in eng._slots.items()
        },
        "rows": {
            str(s): {"blocks": list(row.blocks), "plen": row.plen,
                     "n_shared_full": row.n_shared_full, "tail_shared": row.tail_shared,
                     "cow_dst": row.cow_dst}
            for s, row in eng._rows.items()
        },
        "pool": pool_state,
    }


def _stage(eng: Engine) -> dict:
    """Synchronous device-to-host snapshot at a step boundary.  Every array
    is a real host copy (:func:`_to_savable`), also on the CPU, where
    ``.cpu().numpy()`` would share the cache's memory and the next step's
    in-place writes would reach the writer thread."""
    leaves = cache_leaves(eng.caches)
    arrays = {f"cache_{i:04d}": _to_savable(leaf) for i, leaf in enumerate(leaves)}
    arrays["cur_tok"] = eng._cur_tok.copy()
    dtypes = {f"cache_{i:04d}": dtype_name(leaf.dtype) for i, leaf in enumerate(leaves)}
    dtypes["cur_tok"] = str(arrays["cur_tok"].dtype)
    meta = {
        "format": _FORMAT,
        "step": eng._step_no,
        "n_cache_leaves": len(leaves),
        "scfg": _scfg_fingerprint(eng.scfg),
        "host": _host_state(eng),
        "leaves": {k: [list(v.shape), dtypes[k]] for k, v in arrays.items()},
    }
    return {"arrays": arrays, "meta": meta}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_snapshot(directory: str, name: str, staged: dict, keep: int) -> str:
    """Background-thread body: npz and sha256'd manifest into a tmp
    directory, fsync everything, one rename to publish, then GC."""
    tmp = os.path.join(directory, name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    npz = os.path.join(tmp, "state.npz")
    np.savez(npz, **staged["arrays"])
    with open(npz, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
        os.fsync(f.fileno())
    manifest = dict(staged["meta"], sha256=sha)
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(directory, name)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    _fsync_dir(directory)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    """Drop all but the newest ``keep`` snapshots, and every journal
    segment older than the oldest kept snapshot (those at or after it are
    still needed for replay)."""
    snaps = _snapshot_keys(directory)
    if len(snaps) <= keep:
        return
    kept_floor = snaps[-keep]
    for key in snaps[:-keep]:
        shutil.rmtree(os.path.join(directory, _snap_name(*key)), ignore_errors=True)
    for key in _segment_keys(directory):
        if key < kept_floor:
            try:
                os.remove(os.path.join(directory, _wal_name(*key)))
            except OSError:
                pass


def _load_snapshot(directory: str, key: tuple[int, int]) -> dict:
    """Read and verify one published snapshot; raises CorruptSnapshot on
    any integrity failure (a missing file, a bad sha, an unreadable npz).
    The arrays come back as CPU tensors."""
    path = os.path.join(directory, _snap_name(*key))
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        npz = os.path.join(path, "state.npz")
        with open(npz, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        if sha != manifest.get("sha256"):
            raise CorruptSnapshot(
                f"{path}: state.npz sha256 {sha[:12]}... != manifest "
                f"{str(manifest.get('sha256'))[:12]}..."
            )
        with np.load(npz) as data:
            arrays = {k: _from_savable(data[k], manifest["leaves"][k][1]) for k in data.files}
    except CorruptSnapshot:
        raise
    except Exception as e:
        raise CorruptSnapshot(f"{path}: unreadable snapshot ({e})") from e
    return {"arrays": arrays, "meta": manifest}


def _quarantine(directory: str, key: tuple[int, int]) -> str:
    """Rename a corrupt snapshot out of the recovery search path (kept on
    disk for forensics, never deleted by GC)."""
    src = os.path.join(directory, _snap_name(*key))
    dst = src + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.corrupt{n}"
    os.rename(src, dst)
    return os.path.basename(dst)


# ---------------------------------------------------------------- manager --
class RecoveryManager:
    """The engine's durability driver: journals lifecycle events as they
    happen, commits the journal once a step, and stages and publishes a
    snapshot every ``every`` steps (staging synchronous at the step
    boundary; serialization and the atomic publish on a background
    thread).  Create it through :meth:`attach`."""

    def __init__(self, eng: Engine, directory: str, every: int = 32, keep: int = 3,
                 fsync_every: int = 1):
        os.makedirs(directory, exist_ok=True)
        self.eng = eng
        self.directory = directory
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        self.fsync_every = max(1, int(fsync_every))
        self.gen = max(_disk_generations(directory), default=-1) + 1
        self._thread: threading.Thread | None = None
        # journaled token counts per rid: after_step appends only deltas
        self._logged = {rid: len(out) for rid, out in eng._outputs.items()}
        self._last_snap_step = eng._step_no
        self.journal = Journal(
            os.path.join(directory, _wal_name(self.gen, eng._step_no)),
            fsync_every=self.fsync_every,
        )

    @classmethod
    def attach(cls, eng: Engine, directory: str, every: int = 32, keep: int = 3,
               fsync_every: int = 1) -> "RecoveryManager":
        mgr = cls(eng, directory, every=every, keep=keep, fsync_every=fsync_every)
        eng.recovery = mgr
        if eng._step_no > 0 or eng._reqs:
            # a restored (or mid-flight) engine: anchor the new generation
            # with an immediate snapshot, so its journal segments replay from
            # a self-contained base even after older generations' GC
            mgr.snapshot()
        return mgr

    # ------------------------------------------------------------ hooks --
    def record_submit(self, info: _ReqInfo) -> None:
        self.journal.append(_submit_record(info))
        self._logged[info.rid] = len(self.eng._outputs[info.rid])
        self.journal.commit(force=True)  # durable before submit returns

    def record_cancel(self, rid: int, reason: str) -> None:
        self.journal.append({"t": "cancel", "rid": rid, "reason": reason})
        self.journal.commit(force=True)

    def record_pop(self, rid: int) -> None:
        self.journal.append({"t": "pop", "rid": rid})
        self._logged.pop(rid, None)
        self.journal.commit(force=True)

    def after_step(self) -> None:
        """End-of-step hook: journal this step's emitted-token deltas,
        commit, and snapshot on cadence."""
        eng = self.eng
        for rid, out in eng._outputs.items():
            have = self._logged.get(rid, 0)
            if len(out) > have:
                self.journal.append(
                    {"t": "tok", "rid": rid, "toks": [int(t) for t in out[have:]]}
                )
                self._logged[rid] = len(out)
        self.journal.commit()
        if eng._step_no - self._last_snap_step >= self.every:
            self.snapshot()

    # --------------------------------------------------------- snapshot --
    def snapshot(self) -> None:
        """Stage now (synchronously, at a step boundary), publish in the
        background.  The journal rotates first, so the closed segment holds
        exactly the records up to this snapshot and the fresh one those
        after it."""
        self.wait()
        eng = self.eng
        step = eng._step_no
        self.journal.close()
        self.journal = Journal(
            os.path.join(self.directory, _wal_name(self.gen, step)),
            fsync_every=self.fsync_every,
        )
        staged = _stage(eng)
        self._last_snap_step = step
        self._thread = threading.Thread(
            target=_write_snapshot,
            args=(self.directory, _snap_name(self.gen, step), staged, self.keep),
            daemon=True,
        )
        self._thread.start()
        eng.stats["snapshots"] += 1

    def wait(self) -> None:
        """Block until the snapshot write in flight (if any) has published."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        self.wait()
        self.journal.close()


# ---------------------------------------------------------------- restore --
@dataclasses.dataclass
class RecoveryReport:
    """What a restore did: the launcher prints it, tests assert on it."""

    source: str                      # "snapshot" | "cold" | "fresh"
    snapshot_key: tuple | None       # (gen, step) restored from
    segments: int                    # journal segments replayed
    records: int                     # journal records applied
    torn_lines: int                  # crc-rejected (crash-torn) lines dropped
    resubmitted: int                 # requests rebuilt from submit records
    tokens_replayed: int             # journaled tokens appended past the snapshot
    cancels: int
    pops: int
    quarantined: list[str]           # snapshots renamed *.corrupt by this restore


def replay_lag(eng: Engine) -> int:
    """Tokens the engine still has to re-derive before it has caught up
    with the journal: active slots' replay remainders plus the recorded
    tokens of queued requests.  0 once caught up."""
    lag = 0
    for st in eng._slots.values():
        lag += max(0, st.replay - st.emitted)
    for rid in eng._waiting:
        lag += len(eng._outputs.get(rid, ()))
    return lag


def _apply_snapshot(eng: Engine, snap: dict) -> None:
    """Load a verified snapshot into a fresh engine: the config
    fingerprint and every cache tensor's shape and dtype are checked before
    anything is written, then the tensors are copied into the engine's
    own cache tensors (``copy_``, so every view of them stays valid)."""
    meta = snap["meta"]
    want = _scfg_fingerprint(eng.scfg)
    got = meta["scfg"]
    diff = [k for k in want if want[k] != got.get(k)]
    if diff:
        raise ValueError(
            "snapshot was taken under an incompatible ServeConfig; differing fields: "
            + ", ".join(f"{k}: snapshot={got.get(k)!r} now={want[k]!r}" for k in diff)
        )
    leaves = cache_leaves(eng.caches)
    n = meta["n_cache_leaves"]
    if n != len(leaves):
        raise ValueError(f"snapshot has {n} cache leaves, engine expects {len(leaves)}")
    arrays = []
    for i, leaf in enumerate(leaves):
        arr = snap["arrays"][f"cache_{i:04d}"]
        if tuple(arr.shape) != tuple(leaf.shape) or arr.dtype != leaf.dtype:
            raise ValueError(
                f"snapshot cache leaf {i}: {tuple(arr.shape)}/{dtype_name(arr.dtype)} != "
                f"engine {tuple(leaf.shape)}/{dtype_name(leaf.dtype)}"
            )
        arrays.append(arr)
    for leaf, arr in zip(leaves, arrays):
        leaf.copy_(arr)
    eng._cur_tok = snap["arrays"]["cur_tok"].numpy().astype(np.int64)

    h = meta["host"]
    eng._step_no = int(h["step_no"])
    eng._next_rid = int(h["next_rid"])
    eng._next_seq = int(h["next_seq"])
    eng._stalled = int(h["stalled"])
    eng.stats = {**eng.stats, **{k: int(v) for k, v in h["stats"].items()}}
    eng._free = deque(int(s) for s in h["free"])
    eng._waiting = [int(r) for r in h["waiting"]]
    eng._reqs = {int(r["rid"]): _req_info(r, eng.scfg.seed) for r in h["reqs"]}
    eng._outputs = {int(rid): [int(t) for t in out] for rid, out in h["outputs"].items()}
    eng._slots = {
        int(s): _SlotState(rid=int(st["rid"]), emitted=int(st["emitted"]),
                           budget=int(st["budget"]), replay=int(st["replay"]))
        for s, st in h["slots"].items()
    }
    eng._rows = {
        int(s): _PagedRow(
            blocks=[int(b) for b in row["blocks"]],
            plen=int(row["plen"]),
            n_shared_full=int(row["n_shared_full"]),
            tail_shared=bool(row["tail_shared"]),
            cow_dst=None if row["cow_dst"] is None else int(row["cow_dst"]),
        )
        for s, row in h["rows"].items()
    }
    if eng.pool is not None:
        eng.pool = BlockPool.from_state(h["pool"])
        # the host mirror of the device row lengths (rows without a request
        # keep growing one a step, as on the device)
        eng._row_len = eng.caches["len"][0].cpu().numpy().astype(np.int64)


def _apply_records(eng: Engine, recs: list[dict], report: RecoveryReport) -> list[int]:
    """Replay journal records in order.  Token appends and cancels commute
    per rid (appends extend the recorded output whether or not the request
    is already terminal; a cancel freezes the status, never the recorded
    tokens), so segments concatenated across generations stay consistent.
    Returns the rids whose results were popped before the crash (applied
    last: the client already has them)."""
    pops: list[int] = []
    for rec in recs:
        t = rec["t"]
        rid = int(rec["rid"])
        report.records += 1
        if t == "submit":
            if rid in eng._reqs:
                continue  # already present through the snapshot
            info = _req_info(rec, eng.scfg.seed)
            eng._reqs[rid] = info
            eng._outputs[rid] = []
            eng._next_rid = max(eng._next_rid, rid + 1)
            eng._next_seq = max(eng._next_seq, info.seq + 1)
            if info.status == RequestStatus.WAITING:
                eng._enqueue(info)
            report.resubmitted += 1
        elif t == "tok":
            if rid in eng._outputs:
                toks = [int(x) for x in rec["toks"]]
                eng._outputs[rid].extend(toks)
                report.tokens_replayed += len(toks)
        elif t == "cancel":
            info = eng._reqs.get(rid)
            if info is not None and info.status not in TERMINAL_STATUSES:
                eng.cancel(rid, rec.get("reason", "cancelled"))
            report.cancels += 1
        elif t == "pop":
            pops.append(rid)
            report.pops += 1
    return pops


def restore_engine(
    cfg: Any,
    params: Any,
    scfg: ServeConfig,
    directory: str | None = None,
    device=None,
) -> tuple[Engine, RecoveryReport]:
    """Rebuild a crashed engine from ``directory`` (default
    ``scfg.durability.snapshot_dir``): load the newest snapshot that
    verifies (quarantining corrupt ones), replay every journal segment at
    or after it, re-apply the cancels and pops from before the crash, and
    arm the replay counters so the next steps re-derive the journaled
    tokens, each checked bitwise.  ``scfg`` must match the crashed
    engine's config (its fingerprint is checked); ``params`` are loaded
    afresh (the ABFT weight fingerprint is taken from them).  With
    ``snapshot_dir`` set, a new generation's RecoveryManager is attached
    and takes an anchor snapshot, so a crash during recovery recovers
    too."""
    dur = scfg.durability
    directory = directory or dur.snapshot_dir
    if not directory:
        raise ValueError("restore_engine needs a directory or scfg.durability.snapshot_dir")
    eng = Engine(
        cfg, params,
        dataclasses.replace(scfg, durability=dataclasses.replace(dur, snapshot_dir=None)),
        device=device,
    )
    report = RecoveryReport(
        source="fresh", snapshot_key=None, segments=0, records=0, torn_lines=0,
        resubmitted=0, tokens_replayed=0, cancels=0, pops=0, quarantined=[],
    )
    os.makedirs(directory, exist_ok=True)

    chosen: tuple[int, int] | None = None
    snap = None
    for key in reversed(_snapshot_keys(directory)):
        try:
            snap = _load_snapshot(directory, key)
        except CorruptSnapshot:
            report.quarantined.append(_quarantine(directory, key))
            continue
        chosen = key
        break
    if chosen is not None:
        _apply_snapshot(eng, snap)
        report.source = "snapshot"
        report.snapshot_key = chosen
        if eng.pool is not None and eng.pool.external:
            # external reserve holders died with the crashed process
            eng.pool.unreserve(sorted(eng.pool.external))

    segments = [k for k in _segment_keys(directory) if chosen is None or k >= chosen]
    pops: list[int] = []
    for key in segments:
        recs, torn = read_journal(os.path.join(directory, _wal_name(*key)))
        report.segments += 1
        report.torn_lines += torn
        pops.extend(_apply_records(eng, recs, report))
    if chosen is None and report.records:
        report.source = "cold"

    for rid in pops:
        info = eng._reqs.get(rid)
        if info is None:
            continue
        if info.status not in TERMINAL_STATUSES:
            # the client consumed this result before the crash: finish the
            # zombie through the ordinary release path and evict it
            eng.cancel(rid, "result popped before crash")
        eng.pop_result(rid)

    # arm the teacher-forced replay: active slots re-derive journaled tokens
    # in place; queued requests with recorded tokens replay through
    # _activate's path at re-admission
    for st in eng._slots.values():
        st.replay = len(eng._outputs[st.rid])
    if eng._kv_sums is not None:
        eng._refresh_kv_sums()

    if dur.snapshot_dir:
        RecoveryManager.attach(
            eng, directory, every=dur.snapshot_every, keep=dur.snapshot_keep,
            fsync_every=dur.journal_fsync_every,
        )
        eng.scfg = scfg
    return eng, report
