"""Seeded fault-injection episodes for the serve engine; port of
``repro/serve/chaos.py`` without its crash episodes.

A **lifecycle episode** (:func:`run_episode`) drives a seeded workload with
priorities and deadlines through an :class:`~repro_torch.serve.engine.Engine`
while injecting faults drawn from the same seed: cancels in every live
state (and idempotent re-cancels of terminal requests), forced
preemptions of active or prefilling requests (release -> requeue ->
re-prefill -> bitwise replay), and block-pressure spikes
(``BlockPool.reserve`` withholds free blocks for a few steps), whose
starved admissions the watchdog must shed rather than livelock on.

An **SDC episode** (:func:`run_sdc_episode`) drives a seeded workload
through an ABFT engine while injecting faults drawn from the same seed,
and holds the engine to the detect -> localize -> retry -> quarantine
contract:

  * transient **compute flips** ride the engine's fault operand
    (``Engine.arm_fault``): one bit of one GEMM output or one attention
    output, on the largest element of a row, must be detected on the step
    it strikes and healed by the retry on the plain attention;
  * persistent **KV-pool flips** (:func:`flip_kv_bit`) between steps must
    quarantine exactly the request that owns the block, leak-free;
  * persistent **weight flips** (:func:`flip_weight_bit`) cannot be
    localized (both sides of the checksum identity use the corrupt
    operand): the weight scrub must raise ``SDCUnlocalizedError`` before
    any token is emitted.

After every step :func:`audit` checks the ownership story (pool refcounts
mirror live rows, device tables mirror host tables, every request sits
where its status says); at drain the pool must be leak-free and every
FINISHED request must equal an unfaulted oracle run bitwise (a quarantined
one must be a prefix of it).  Sampling folds only ``(seed, request id,
token index)``, so the unfaulted run is ground truth for any faulted
interleaving.  Episodes are pure functions of ``(engine config, seed)``.

Not ported yet: the crash episodes (``run_crash_episode``), which wait
for recovery (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import abft
from repro_torch.serve import kvcache
from repro_torch.serve.engine import (
    SDC_RETRY_BUDGET,
    TERMINAL_STATUSES,
    Engine,
    Request,
    RequestStatus,
)

# the test matrices draw episode seeds as <env seed> + SEED_STRIDE + episode,
# so a failed episode's exact repro is <env var>=1 <seed var>=<seed - STRIDE>
SEED_STRIDE = 1000


def repro_command(
    seed: int,
    episodes_var: str = "SDC_EPISODES",
    target: str = "tests/test_torch_sdc.py",
    seed_var: str = "SDC_SEED",
) -> str:
    """The shell command that replays one episode of the seeded matrix
    (episode seeds are ``<seed_var> + SEED_STRIDE + ep``)."""
    return (
        f"{episodes_var}=1 {seed_var}={seed - SEED_STRIDE} "
        f"PYTHONPATH=src python -m pytest -q {target}"
    )


def episode_header(
    kind: str,
    seed: int,
    episodes_var: str = "SDC_EPISODES",
    target: str = "tests/test_torch_sdc.py",
    seed_var: str = "SDC_SEED",
) -> str:
    """Print (and return) the episode banner: seed, the generator's initial
    internal state (proof the episode is a pure function of the seed), and
    the command that replays it."""
    state = np.random.default_rng(seed).bit_generator.state["state"]["state"]
    cmd = repro_command(seed, episodes_var, target, seed_var)
    print(f"[chaos] {kind} episode seed={seed} pcg64_state={state:#x} repro: {cmd}", flush=True)
    return cmd


def check_device_tables(eng: Engine) -> None:
    """Device block tables of live rows must mirror host ownership, every
    entry past the reserved span aimed at the sink.  A pending CoW is the
    one legal divergence: the device row still aims at the shared tail
    until ``_resolve_cow`` repoints it."""
    tables = eng.caches["table"][0].cpu().numpy()
    for slot, row in eng._rows.items():
        want = np.full((tables.shape[1],), kvcache.SINK_BLOCK, np.int32)
        want[: len(row.blocks)] = row.blocks
        got = tables[slot]
        if row.cow_dst is not None:
            lb = row.plen // eng.scfg.kv.block_size
            want[lb] = got[lb]
        assert np.array_equal(got, want), (
            f"slot {slot}: device table {got.tolist()} != host ownership {want.tolist()}"
        )


def audit(eng: Engine) -> None:
    """Ownership and status consistency, cheap enough after every step:
    pool refcounts mirror live rows (the lane's and external reservations
    included), device tables mirror host tables, and every request id sits
    exactly where its status says."""
    if eng.pool is not None:
        eng.pool.assert_invariants(eng.live_block_refs())
        check_device_tables(eng)
    queued = set(eng._waiting)
    active = {st.rid for st in eng._slots.values()}
    assert not queued & active, f"rids both queued and active: {queued & active}"
    prefilling = set()
    if eng._lane is not None:
        prefilling = {eng._lane.rid}
        assert eng._lane.slot not in eng._slots, (
            f"lane slot {eng._lane.slot} double-booked by an active row"
        )
        assert eng._lane.slot not in eng._free, (
            f"lane slot {eng._lane.slot} still on the free ring"
        )
        assert not prefilling & (queued | active), (
            f"rid {eng._lane.rid} PREFILLING but also scheduled elsewhere"
        )
    for rid, info in eng._reqs.items():
        if info.status in (RequestStatus.WAITING, RequestStatus.PREEMPTED):
            assert rid in queued, f"rid {rid} {info.status} but not queued"
        elif info.status == RequestStatus.ACTIVE:
            assert rid in active, f"rid {rid} ACTIVE but holds no slot"
        elif info.status == RequestStatus.PREFILLING:
            assert rid in prefilling, f"rid {rid} PREFILLING but holds no lane"
        else:
            assert info.status in TERMINAL_STATUSES
            assert rid not in queued and rid not in active, (
                f"rid {rid} terminal ({info.status}) but still scheduled"
            )


def oracle_outputs(oracle: Engine, reqs: list[Request]) -> dict[int, list[int]]:
    """Ground-truth tokens per request: the same workload, stripped of
    deadlines and priorities (they change scheduling only, which sampling
    does not depend on), through an unfaulted engine, which must share
    seed, temperature and max_len with the faulted one."""
    bare = [Request(r.prompt, r.max_new_tokens, request_id=r.request_id) for r in reqs]
    outs = oracle.run(bare)
    for r, o in zip(bare, outs):
        assert o.status == RequestStatus.FINISHED, (
            f"oracle run must finish everything: rid {r.request_id} ended {o.status}"
        )
    return {r.request_id: o.tolist() for r, o in zip(bare, outs)}


# ------------------------------------------------------ lifecycle episodes --


@dataclasses.dataclass
class ChaosConfig:
    """Fault-schedule knobs of a lifecycle episode; every random draw comes
    from the episode's seeded generator, so the same (config, seed)
    replays the same chaos."""

    n_requests: int = 10
    max_new: int = 8              # budgets drawn from [1, max_new]
    share_p: float = 0.5          # fraction extending a shared prefix
    p_cancel: float = 0.12        # per-step: cancel one live request
    p_dead_cancel: float = 0.05   # per-step: re-cancel a terminal request
    p_preempt: float = 0.12       # per-step: force-preempt one active
    p_spike: float = 0.08         # per-step: start a block-pressure spike
    spike_blocks: int = 6         # spike size upper bound
    spike_steps: int = 5          # spike duration upper bound
    p_deadline: float = 0.25      # per-request: attach a deadline
    deadline_lo: int = 2
    deadline_hi: int = 40
    p_priority: float = 0.3       # per-request: non-zero priority (1..3)
    burst_hi: int = 4             # submissions per step upper bound
    max_steps: int = 1000         # drain bound (fail = livelock)


@dataclasses.dataclass
class EpisodeReport:
    """What one lifecycle episode did, aggregated by the test matrix to
    prove every fault type fired across the episode set."""

    seed: int
    steps: int
    statuses: dict[str, int]
    stats: dict[str, int]         # engine lifecycle counters (this episode's)


def make_chaos_workload(
    rng: np.random.Generator, vocab: int, max_len: int, ccfg: ChaosConfig
) -> list[Request]:
    """Mixed prompts (a slice sharing prefixes, sometimes exactly: tail
    sharing and copy-on-write under fire), random budgets, deadlines on
    ~``p_deadline`` of them and priorities on ~``p_priority``; the
    reference's draws, in order."""
    prefixes = [
        rng.integers(0, vocab, int(rng.integers(8, max_len // 2))).astype(np.int32)
        for _ in range(3)
    ]
    reqs = []
    for i in range(ccfg.n_requests):
        if rng.random() < ccfg.share_p:
            pre = prefixes[int(rng.integers(len(prefixes)))]
            extra = int(rng.integers(0, 6))  # 0 => identical prompt
            prompt = np.concatenate([pre, rng.integers(0, vocab, extra).astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(1, max_len - 8))).astype(np.int32)
        deadline = None
        if rng.random() < ccfg.p_deadline:
            deadline = int(rng.integers(ccfg.deadline_lo, ccfg.deadline_hi))
        priority = int(rng.integers(1, 4)) if rng.random() < ccfg.p_priority else 0
        reqs.append(
            Request(
                prompt[: max_len - 4],
                max_new=int(rng.integers(1, ccfg.max_new + 1)),
                request_id=i,
                priority=priority,
                deadline_steps=deadline,
            )
        )
    return reqs


def run_episode(
    eng: Engine,
    oracle: dict[int, list[int]],
    reqs: list[Request],
    seed: int,
    ccfg: ChaosConfig,
) -> EpisodeReport:
    """Drive one seeded lifecycle episode through ``eng`` (reused across
    episodes: it must enter drained).  Audits ownership after every step,
    then asserts a leak-free drain and bitwise oracle agreement: FINISHED
    requests (preempted and recovered ones included) equal the oracle,
    cancelled, expired and shed ones are prefixes of it."""
    assert (
        not eng._reqs and not eng._slots and not eng._waiting and eng._lane is None
    ), "chaos episode needs a drained engine"
    cmd = episode_header(
        "fault", seed, "CHAOS_EPISODES", "tests/test_torch_chaos_lifecycle.py", "CHAOS_SEED"
    )
    rng = np.random.default_rng(seed)
    stats0 = dict(eng.stats)  # engines are reused: report per-episode deltas
    pending = list(rng.permutation(len(reqs)))
    spikes: list[tuple[list[int], int]] = []   # (reserved blocks, expiry)
    steps = 0
    rids = [r.request_id for r in reqs]

    def live(statuses):
        return [r for r in rids if eng.status(r) in statuses]

    while pending or eng._slots or eng._waiting or eng._lane is not None:
        for _ in range(int(rng.integers(0, ccfg.burst_hi + 1))):
            if pending:
                eng.submit(reqs[pending.pop(0)])
        # fault injection: host-side, between steps, fully seeded
        if rng.random() < ccfg.p_cancel:
            victims = live((
                RequestStatus.WAITING, RequestStatus.ACTIVE,
                RequestStatus.PREFILLING, RequestStatus.PREEMPTED,
            ))
            if victims:
                eng.cancel(victims[int(rng.integers(len(victims)))])
        if rng.random() < ccfg.p_dead_cancel:
            dead = live(TERMINAL_STATUSES)
            if dead:
                rid = dead[int(rng.integers(len(dead)))]
                before = eng.status(rid)
                assert eng.cancel(rid) == before, "double-cancel not idempotent"
                assert eng.status(rid) == before
        if rng.random() < ccfg.p_preempt:
            actives = live((RequestStatus.ACTIVE, RequestStatus.PREFILLING))
            if actives:
                eng.preempt(actives[int(rng.integers(len(actives)))])
        if eng.pool is not None and rng.random() < ccfg.p_spike:
            held = eng.pool.reserve(int(rng.integers(1, ccfg.spike_blocks + 1)))
            if held:
                expiry = steps + int(rng.integers(1, ccfg.spike_steps + 1))
                spikes.append((held, expiry))
        eng.step()
        steps += 1
        for held, expiry in [s for s in spikes if s[1] <= steps]:
            eng.pool.unreserve(held)
            spikes.remove((held, expiry))
        audit(eng)
        assert steps < ccfg.max_steps, (
            f"chaos episode seed={seed} failed to drain in {steps} steps "
            f"(livelock: watchdog or shedding broken?); repro: {cmd}"
        )
    for held, _ in spikes:
        eng.pool.unreserve(held)
    audit(eng)
    if eng.pool is not None:
        assert eng.pool.free_blocks == eng.pool.num_blocks - 1, (
            f"chaos episode seed={seed} leaked "
            f"{eng.pool.num_blocks - 1 - eng.pool.free_blocks} blocks; repro: {cmd}"
        )

    statuses: dict[str, int] = {}
    for r in reqs:
        res = eng.pop_result(r.request_id)
        statuses[res.status.value] = statuses.get(res.status.value, 0) + 1
        want = oracle[r.request_id]
        got = res.tolist()
        if res.status == RequestStatus.FINISHED:
            assert got == want, (
                f"chaos episode seed={seed} rid {r.request_id} "
                f"(preemptions={res.preemptions}): FINISHED output {got} != "
                f"oracle {want}; repro: {cmd}"
            )
        else:
            # cancelled / expired / shed mid-flight: whatever was generated
            # must still be the oracle's prefix, bitwise
            assert got == want[: len(got)], (
                f"chaos episode seed={seed} rid {r.request_id} ({res.status}): "
                f"partial output {got} is not a prefix of oracle {want}; repro: {cmd}"
            )
    return EpisodeReport(
        seed=seed,
        steps=steps,
        statuses=statuses,
        stats={k: v - stats0.get(k, 0) for k, v in eng.stats.items()},
    )


# ------------------------------------------------------------ SDC episodes --


@dataclasses.dataclass
class FaultPlan:
    """One scheduled injection: ``kind`` is "matmul", "attention" or "kv";
    compute-fault targeting (call_idx / layer / row / bit) is drawn by
    :func:`run_sdc_episode` once the engine's probe knows the step's check
    sites."""

    kind: str
    call_idx: int = 0
    layer: int = abft.FAULT_OUTER
    row: int = 0
    bit: int = 27
    fired: bool = False


def _flip_exponent_msb(cell: torch.Tensor) -> None:
    """Flip the exponent MSB of a one-element view, in place."""
    if cell.element_size() == 2:  # bf16: sign 15, exponent 14..7
        cell.view(torch.int16).bitwise_xor_(1 << 14)
    else:                         # fp32: sign 31, exponent 30..23
        cell.view(torch.int32).bitwise_xor_(1 << 30)


def flip_kv_bit(eng: Engine, rng: np.random.Generator) -> tuple[int, int] | None:
    """Flip the exponent MSB of one seeded element inside an owned,
    uniquely referenced KV-pool block that was NOT legally written this
    step: the corruption the per-block audit owes a detection for at the
    top of the next step.  The exponent MSB changes the block's abs-sum by
    at least ~2.0, so the fp32 sum changes representably; unique
    referencing pins the blast radius to one request.  The element is
    flipped in place on the device (no copy of the pool).

    Returns ``(victim_rid, block)`` or None when no block is eligible."""
    refs = eng.live_block_refs()
    cands = []
    for slot, row in sorted(eng._rows.items()):
        if slot not in eng._slots:
            continue
        for b in row.blocks:
            if refs.get(b, 0) == 1 and b not in eng._touched and b != row.cow_dst:
                cands.append((slot, b))
    if not cands:
        return None
    slot, block = cands[int(rng.integers(len(cands)))]
    kp = eng.caches["kpool"]
    flat = kp.view(kp.shape[0], kp.shape[1], -1)
    li = int(rng.integers(flat.shape[0]))
    ei = int(rng.integers(flat.shape[2]))
    _flip_exponent_msb(flat[li, block, ei : ei + 1])
    return eng._slots[slot].rid, block


def _replace_leaf(tree, i: int, leaf: torch.Tensor):
    """``tree`` with its ``i``-th leaf (``abft._leaves`` order) replaced;
    every other leaf is shared, not copied."""
    keys: list[tuple] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            keys.append(path)

    walk(tree, ())

    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,)) for k, v in t.items()}
        return leaf if path == keys[i] else t

    return rebuild(tree, ())


def flip_weight_bit(params, rng: np.random.Generator) -> tuple[dict, int]:
    """Return ``(corrupted_params, leaf_ordinal)``: the parameter tree with
    the exponent MSB of one seeded element of one seeded leaf flipped, in a
    copy of that leaf.  Models persistent weight rot: the checksums cannot
    see it, so the engine's weight fingerprint must raise
    :class:`~repro_torch.serve.engine.SDCUnlocalizedError`."""
    leaves = abft._leaves(params)
    li = int(rng.integers(len(leaves)))
    leaf = leaves[li].clone()
    flat = leaf.view(-1)
    idx = int(rng.integers(flat.shape[0]))
    _flip_exponent_msb(flat[idx : idx + 1])
    return _replace_leaf(params, li, leaf), li


@dataclasses.dataclass
class SDCEpisodeReport:
    """One SDC episode's ledger, aggregated by the test matrix to prove
    every fault surface fired AND was caught."""

    seed: int
    steps: int
    injected: dict[str, int]      # faults that fired, by kind
    detected: int                 # checksum/fingerprint detections (compute)
    retried: int                  # re-executions on the plain attention
    quarantined: int              # KV-flip quarantines
    statuses: dict[str, int]


def make_sdc_workload(
    rng: np.random.Generator, vocab: int, max_len: int, n_requests: int = 8
) -> list[Request]:
    """Plain seeded prompts (no shared prefixes, no deadlines): every
    divergence from the oracle must be the injector's doing."""
    return [
        Request(
            rng.integers(0, vocab, int(rng.integers(4, max_len // 2))).astype(np.int32),
            max_new=int(rng.integers(4, 12)),
            request_id=i,
        )
        for i in range(n_requests)
    ]


def run_sdc_episode(
    eng: Engine,
    oracle: dict[int, list[int]],
    reqs: list[Request],
    seed: int,
    n_compute: int | None = None,
    n_kv: int | None = None,
    max_steps: int = 400,
) -> SDCEpisodeReport:
    """One seeded SDC episode through a reused (drained) abft engine: drive
    the workload, firing ``n_compute`` transient compute flips and ``n_kv``
    persistent KV-pool flips at seeded steps (``None`` draws the counts
    from the seed).  Asserts the contract:

      * every fired compute fault is detected and retried exactly once
        (``n_compute <= SDC_RETRY_BUDGET``, so no budget quarantine muddies
        the ledger; the budget path has its own test);
      * every fired KV flip quarantines exactly its owning request, with an
        ``"sdc"``-prefixed FAILED reason;
      * a clean episode detects and quarantines NOTHING;
      * the pool drains leak-free and every FINISHED request equals the
        oracle bitwise (quarantined ones are bitwise prefixes).
    """
    assert eng._abft, "run_sdc_episode needs KernelConfig.abft != 'off'"
    assert not eng._reqs and not eng._slots and not eng._waiting, (
        "sdc episode needs a drained engine"
    )
    cmd = episode_header("sdc", seed)
    rng = np.random.default_rng(seed)
    stats0 = dict(eng.stats)
    if n_compute is None:
        n_compute = int(rng.integers(0, SDC_RETRY_BUDGET + 1))
    if n_kv is None:
        n_kv = int(rng.integers(0, 3))
    assert n_compute <= SDC_RETRY_BUDGET, (
        "per-episode compute faults beyond the retry budget would quarantine "
        "every live slot; test that path explicitly instead"
    )
    plans = [FaultPlan("matmul" if rng.random() < 0.5 else "attention")
             for _ in range(n_compute)]
    plans += [FaultPlan("kv") for _ in range(n_kv)]
    plans = [plans[i] for i in rng.permutation(len(plans))]
    pending = list(rng.permutation(len(reqs)))
    kv_victims: list[int] = []
    steps = 0
    next_fire = 1 + int(rng.integers(0, 3))

    def arm_compute(plan: FaultPlan) -> bool:
        # check-site counts of one step (known after the first abft step);
        # the lone matmul outside the layer loop is the unembed, mms - 1
        mms = eng._abft_probe.get("mms", 0)
        attns = eng._abft_probe.get("attns", 0)
        live = sorted(eng._slots)
        if plan.kind == "attention":
            sampled = set(abft.sample_rows(eng.scfg.scheduler.batch, eng._abft))
            live = [s for s in live if s in sampled]
            if not live or not attns:
                return False
            plan.call_idx = int(rng.integers(attns))
            plan.layer = int(rng.integers(eng.cfg.n_layers))
            site = abft.FAULT_ATTENTION
        else:
            if not live or not mms:
                return False
            if mms == 1 or rng.random() < 0.25:
                plan.call_idx, plan.layer = mms - 1, abft.FAULT_OUTER
            else:
                plan.call_idx = int(rng.integers(mms - 1))
                plan.layer = int(rng.integers(eng.cfg.n_layers))
            site = abft.FAULT_MATMUL
        plan.row = live[int(rng.integers(len(live)))]
        # exponent flips on the row's largest element (col = -1): the one
        # corruption class a bf16 checksum provably owes a detection for
        plan.bit = int(rng.integers(24, 30))
        eng.arm_fault(site, plan.call_idx, plan.row, -1, plan.bit, plan.layer)
        return True

    while pending or eng._slots or eng._waiting:
        for _ in range(int(rng.integers(1, 4))):
            if pending:
                eng.submit(reqs[pending.pop(0)])
        if plans and steps >= next_fire and eng._slots:
            plan = plans[0]
            if plan.kind == "kv":
                hit = flip_kv_bit(eng, rng)
                if hit is not None:
                    kv_victims.append(hit[0])
                    plan.fired = True
            else:
                plan.fired = arm_compute(plan)
            if plan.fired:
                plans.pop(0)
                # gap >= 2: the previous fault's quarantine (if any) must
                # settle before the next fault picks a victim row
                next_fire = steps + 2 + int(rng.integers(0, 3))
        eng.step()
        steps += 1
        audit(eng)
        assert steps < max_steps, (
            f"sdc episode seed={seed} failed to drain in {steps} steps; repro: {cmd}"
        )
    audit(eng)
    assert eng.pool.free_blocks == eng.pool.num_blocks - 1, (
        f"sdc episode seed={seed} leaked {eng.pool.num_blocks - 1 - eng.pool.free_blocks} "
        f"blocks after quarantine; repro: {cmd}"
    )

    for p in plans:  # anything left never found an eligible target
        assert not p.fired
    fired_compute = n_compute - sum(1 for p in plans if p.kind in ("matmul", "attention"))
    fired_kv = len(kv_victims)
    delta = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
    assert delta["sdc_detected"] == fired_compute, (
        f"sdc episode seed={seed}: {fired_compute} compute faults fired but "
        f"{delta['sdc_detected']} were detected; repro: {cmd}"
    )
    assert delta["sdc_retried"] == fired_compute, (
        f"sdc episode seed={seed}: detection without the one-for-one retry "
        f"({delta['sdc_retried']} != {fired_compute}); repro: {cmd}"
    )
    assert delta["quarantined"] == fired_kv, (
        f"sdc episode seed={seed}: {fired_kv} KV flips fired but "
        f"{delta['quarantined']} requests were quarantined; repro: {cmd}"
    )

    statuses: dict[str, int] = {}
    for r in reqs:
        res = eng.pop_result(r.request_id)
        statuses[res.status.value] = statuses.get(res.status.value, 0) + 1
        want = oracle[r.request_id]
        got = res.tolist()
        if res.status == RequestStatus.FINISHED:
            assert got == want, (
                f"sdc episode seed={seed} rid {r.request_id}: FINISHED output {got} "
                f"!= oracle {want} (a fault survived detection or the retry "
                f"diverged); repro: {cmd}"
            )
        else:
            assert res.status == RequestStatus.FAILED, (
                f"sdc episode seed={seed} rid {r.request_id}: unexpected terminal "
                f"status {res.status}; repro: {cmd}"
            )
            assert r.request_id in kv_victims, (
                f"sdc episode seed={seed} rid {r.request_id}: FAILED but never "
                f"targeted by a KV flip ({res.reason!r}); repro: {cmd}"
            )
            assert res.reason.startswith("sdc"), (
                f"sdc episode seed={seed} rid {r.request_id}: quarantine reason "
                f"{res.reason!r} not sdc-attributed; repro: {cmd}"
            )
            assert got == want[: len(got)], (
                f"sdc episode seed={seed} rid {r.request_id}: quarantined prefix "
                f"{got} diverged from oracle {want}; repro: {cmd}"
            )
    return SDCEpisodeReport(
        seed=seed,
        steps=steps,
        injected={"compute": fired_compute, "kv": fired_kv},
        detected=delta["sdc_detected"],
        retried=delta["sdc_retried"],
        quarantined=delta["quarantined"],
        statuses=statuses,
    )
