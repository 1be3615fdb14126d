"""Slot-based batched KV cache for the continuous-batching engine; port of
``repro/serve/kvcache.py`` (every decoder family, plus the paged layout).

Contiguous layout: one ``(slots, max_len)`` KV ring per layer, stacked
over layers (dense, MoE and VLM models); for RWKV-6 one recurrent state
``(slots, H, 64, 64)`` fp32 and one token-shift row ``(slots, D)`` per
layer; for the hybrid family a nested tree of window-sized KV rings and
RG-LRU states (``h`` and the conv history); for gemma3's local:global
pattern groups of window-sized local rings and a ``max_len`` global
cache, plus a tail of local rings.  The slot helpers walk the nested
trees leaf by leaf.  Paged layout:
per-layer block pools ``(num_blocks, block_size, KV, hd)``, per-row block
tables and lengths, with ownership (refcounts, free list, radix prefix
index) kept host-side in :class:`BlockPool`.

Every device operation here writes its cache **in place** and returns the
same dict: the reference expresses these as donated scatters that XLA
aliases to their inputs, which in PyTorch is simply an indexed write.
"""

from __future__ import annotations

import torch

from repro_torch.arch import layers as L
from repro_torch.arch import rglru as G
from repro_torch.arch import rwkv as R
from repro_torch.arch.transformer import GLOBAL_WINDOW, layer_windows
from repro_torch.configs.base import ModelConfig


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dict trees of one structure; a None
    subtree (a hybrid model without groups or tail) stays None."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(one: dict, n: int) -> dict:
    """``n`` copies of a one-layer cache stacked on a new leading axis."""
    return {k: v[None].expand((n,) + v.shape).clone() for k, v in one.items()}


def build_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Decode caches for ``batch`` slots of ``max_len`` positions each,
    stacked over layers: leaves ``(L, batch, size, ...)``; for RWKV-6
    ``state`` ``(L, batch, H, 64, 64)`` and ``x_prev`` ``(L, batch, D)``; for
    the hybrid family ``{"groups": {"rnn": ..., "attn": ...}, "tail": ...}``
    with the RG-LRU's ``h`` ``(.., batch, W)`` fp32 and ``conv``
    ``(.., batch, K-1, W)`` under ``(n_groups, rnn_per)`` and ``(rem,)``
    axes, and window-sized KV rings under ``(n_groups,)``; for a
    local:global pattern ``{"groups": {"local": ..., "global": ...},
    "tail": ...}`` with window-sized rings under ``(n_groups,
    global_every - 1)`` and ``(n_tail,)`` (None without a tail) and
    ``max_len`` caches under ``(n_groups,)``."""
    if cfg.family == "hybrid":
        ng, rem = divmod(cfg.n_layers, cfg.rnn_per_attention + 1)
        groups = None
        if ng:
            ring = L.init_kv_cache(cfg, batch, max_len, cfg.sliding_window, device)
            groups = {
                "rnn": G.rglru_init_cache(cfg, batch, device, lead=(ng, cfg.rnn_per_attention)),
                "attn": _stack(ring, ng),
            }
        tail = G.rglru_init_cache(cfg, batch, device, lead=(rem,)) if rem else None
        return {"groups": groups, "tail": tail}
    if cfg.mixer == "rwkv6":
        return R.rwkv_init_cache(cfg, batch, device, lead=(cfg.n_layers,))
    if cfg.global_every:
        ge = cfg.global_every
        ng, n_tail = divmod(cfg.n_layers, ge)
        local = L.init_kv_cache(cfg, batch, max_len, cfg.sliding_window, device)
        glob = L.init_kv_cache(cfg, batch, max_len, None, device)
        return {
            "groups": {"local": _stack(_stack(local, ge - 1), ng), "global": _stack(glob, ng)},
            "tail": _stack(local, n_tail) if n_tail else None,
        }
    w = int(layer_windows(cfg)[0])  # uniform over layers on this path
    one = L.init_kv_cache(
        cfg, batch, max_len, None if w >= GLOBAL_WINDOW else w, device
    )
    return _stack(one, cfg.n_layers)


def slot_axes(cfg: ModelConfig, max_len: int) -> dict:
    """Per-leaf index of the slot (batch) axis, found by building the cache
    at two batch sizes on the meta device and diffing shapes (hybrid rnn
    leaves are ``(ng, rnn_per, B, ...)``, attention leaves ``(L, B, ...)``)."""
    return _tree_map(
        lambda x, y: next(i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n),
        build_caches(cfg, 1, max_len, device="meta"),
        build_caches(cfg, 2, max_len, device="meta"),
    )


def slot_store(big: dict, small: dict, slot: int, axes: dict) -> dict:
    """Write row 0 of a batch-1 cache into slot ``slot`` of a batched one,
    in place."""
    _tree_map(lambda b, s, ax: b.select(ax, slot).copy_(s.select(ax, 0)), big, small, axes)
    return big


def take_slot(caches: dict, row: int, axes: dict) -> dict:
    """One slot of a batched cache as views, slot axis kept at extent 1."""
    return _tree_map(lambda c, ax: c.narrow(ax, row, 1), caches, axes)


def mask_prompt_tail(caches: dict, true_len: torch.Tensor) -> dict:
    """Invalidate entries a right-padded prefill wrote past the real prompt,
    in place, in every KV cache of the tree: ``pos`` returns to the +1e9
    empty sentinel and ``len`` rewinds to the true length.  ``true_len`` is
    per row ``(B,)``.  Valid only for non-ring caches, where slot index ==
    position.  Recurrent caches (no ``pos``/``len``) are left as they are."""
    if caches is None:
        return caches
    if "pos" not in caches:
        for sub in caches.values():
            if isinstance(sub, dict):
                mask_prompt_tail(sub, true_len)
        return caches
    tl = true_len.to(torch.int32)
    pos = caches["pos"]
    idx = torch.arange(pos.shape[-1], dtype=torch.int32, device=pos.device)
    pos.masked_fill_(idx >= tl[..., None], 10**9)
    caches["len"].copy_(tl.expand_as(caches["len"]))
    return caches


# ------------------------------------------------------------ paged layout --
#
# kpool/vpool: (L, num_blocks, block_size, kv_heads, head_dim)
# table:       (L, batch, max_len // block_size) int32, logical -> physical
# len:         (L, batch) int32 live tokens per row
#
# Physical block 0 is the SINK: never allocated; evicted rows aim every
# table entry at it so the always-full-batch decode's writes for dead rows
# land somewhere harmless.  Prefix sharing keys each block by (previous
# physical block, its tokens) -- a radix chain.  A shared partial prompt
# tail is copied on the attaching request's first write (copy-on-write).


def supports_paged(cfg: ModelConfig) -> bool:
    """The paged layout stores one uniform KV pool per layer and masks
    purely by live length, so every layer must be global attention."""
    return (
        cfg.family in ("dense", "moe")
        and cfg.mixer == "attention"
        and cfg.sliding_window is None
        and not cfg.global_every
    )


def build_paged_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    num_blocks: int,
    block_size: int,
    device=None,
) -> dict:
    if not supports_paged(cfg):
        raise ValueError(f"paged KV layout unsupported for {cfg.name}")
    if max_len % block_size:
        raise ValueError(f"max_len {max_len} not a multiple of block_size {block_size}")
    kv, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    sd = L.dtype_of(cfg)
    pool = (n, num_blocks, block_size, kv, hd)
    return {
        "kpool": torch.zeros(pool, dtype=sd, device=device),
        "vpool": torch.zeros(pool, dtype=sd, device=device),
        "table": torch.zeros((n, batch, max_len // block_size), dtype=torch.int32, device=device),
        "len": torch.zeros((n, batch), dtype=torch.int32, device=device),
    }


def paged_store_row_blocks(
    caches: dict, scratch: dict, row: int, start_lb: int, phys: torch.Tensor
) -> dict:
    """Pack ``len(phys)`` consecutive logical blocks of row ``row`` of a
    freshly prefilled contiguous scratch (leaves ``(L, n, S, kv, hd)``),
    starting at logical block ``start_lb``, into pool blocks ``phys``, in
    place."""
    n_pack = phys.shape[0]
    n, _, bs, kv, hd = caches["kpool"].shape
    lo = start_lb * bs
    for pool, src in (("kpool", "k"), ("vpool", "v")):
        blocks = scratch[src][:, row, lo : lo + n_pack * bs].reshape(n, n_pack, bs, kv, hd)
        caches[pool][:, phys.long()] = blocks.to(caches[pool].dtype)
    return caches


def paged_set_row(
    caches: dict, row: int, table_row: torch.Tensor, length: int
) -> dict:
    """Write one row's block table and live length in every layer, in
    place (admission fills it; eviction resets it to all-sink / zero)."""
    caches["table"][:, row] = table_row.to(torch.int32)
    caches["len"][:, row] = length
    return caches


def paged_copy_block(caches: dict, row: int, lb: int, src: int, dst: int) -> dict:
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` in every
    layer's pools and repoint row ``row``'s logical block ``lb`` at it."""
    caches["kpool"][:, dst] = caches["kpool"][:, src]
    caches["vpool"][:, dst] = caches["vpool"][:, src]
    caches["table"][:, row, lb] = dst
    return caches


SINK_BLOCK = 0  # physical block 0: garbage target for dead rows, never owned


class BlockPool:
    """Host-side block ownership for the paged KV cache: a free list,
    per-block refcounts, and the radix-chain prefix index.

    Invariants (checked by :meth:`assert_invariants`):

      * refcount[b] == number of (live request, logical slot) references
        to b, for every non-sink block;
      * the free list and the referenced set partition ``[1, num_blocks)``;
      * every prefix-index entry points at a block with refcount >= 1.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block + sink")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcount = [0] * num_blocks
        self.free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop() = 1
        # (prev_physical_block, tokens-in-block) -> physical block
        self.index: dict[tuple[int, tuple[int, ...]], int] = {}
        self._keys_of: dict[int, list] = {}
        # blocks held by an external actor, accounted by assert_invariants
        self.external: set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def alloc(self) -> int:
        bid = self.free.pop()
        assert self.refcount[bid] == 0, bid
        self.refcount[bid] = 1
        return bid

    def retain(self, bid: int) -> None:
        assert self.refcount[bid] > 0, f"retain of unowned block {bid}"
        self.refcount[bid] += 1

    def release(self, bid: int) -> None:
        assert self.refcount[bid] > 0, f"release of unowned block {bid}"
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            for key in self._keys_of.pop(bid, ()):
                if self.index.get(key) == bid:
                    del self.index[key]
            self.free.append(bid)

    def reserve(self, n: int) -> list[int]:
        """Withhold up to ``n`` free blocks for an external actor; returns
        the block ids actually reserved."""
        got = []
        for _ in range(min(n, len(self.free))):
            bid = self.alloc()
            self.external.add(bid)
            got.append(bid)
        return got

    def unreserve(self, bids: list[int]) -> None:
        for bid in bids:
            assert bid in self.external, f"unreserve of non-reserved block {bid}"
            self.external.discard(bid)
            self.release(bid)

    def register(self, prev: int, tokens: tuple[int, ...], bid: int) -> None:
        """Expose a block's content to future prefix matches (first
        registration wins)."""
        key = (prev, tokens)
        if key not in self.index:
            self.index[key] = bid
            self._keys_of.setdefault(bid, []).append(key)

    def match_prefix(self, tokens: list[int]) -> tuple[list[int], int | None]:
        """Walk the radix chain over the prompt: (shared full blocks,
        shared-tail block or None).  The tail matches only when every full
        block matched and the partial content is identical."""
        bs = self.block_size
        shared: list[int] = []
        prev = -1
        n_full = len(tokens) // bs
        for i in range(n_full):
            bid = self.index.get((prev, tuple(tokens[i * bs : (i + 1) * bs])))
            if bid is None:
                return shared, None
            shared.append(bid)
            prev = bid
        tail = tokens[n_full * bs :]
        if not tail or len(shared) != n_full:
            return shared, None
        return shared, self.index.get((prev, tuple(tail)))

    def to_state(self) -> dict:
        """JSON-safe image of the whole ownership state, the prefix index
        included (as ``[prev, tokens, bid]``), for the engine snapshot: a
        restored pool keeps aliasing the restored device blocks."""
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "refcount": list(self.refcount),
            "free": list(self.free),
            "external": sorted(self.external),
            "index": [[prev, list(tokens), bid] for (prev, tokens), bid in self.index.items()],
        }

    @classmethod
    def from_state(cls, state: dict) -> "BlockPool":
        """Rebuild a pool from :meth:`to_state` output (``_keys_of`` is
        re-derived through :meth:`register`)."""
        pool = cls(int(state["num_blocks"]), int(state["block_size"]))
        pool.refcount = [int(c) for c in state["refcount"]]
        pool.free = [int(b) for b in state["free"]]
        pool.external = {int(b) for b in state["external"]}
        for prev, tokens, bid in state["index"]:
            pool.register(int(prev), tuple(int(t) for t in tokens), int(bid))
        return pool

    def assert_invariants(self, live_refs: dict[int, int]) -> None:
        """``live_refs``: physical block -> references derived from the
        engine's live rows.  Raises on any ownership drift."""
        for bid in range(1, self.num_blocks):
            want = live_refs.get(bid, 0) + (1 if bid in self.external else 0)
            assert self.refcount[bid] == want, (
                f"block {bid}: refcount {self.refcount[bid]} != live refs {want}"
            )
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "free list has duplicates"
        assert SINK_BLOCK not in free_set, "sink block leaked into free list"
        for bid in free_set:
            assert self.refcount[bid] == 0, f"free block {bid} has refs"
        owned = {b for b, c in enumerate(self.refcount) if c > 0}
        assert owned | free_set == set(range(1, self.num_blocks)), (
            "free list + owned blocks do not partition the pool"
        )
        for key, bid in self.index.items():
            assert self.refcount[bid] > 0, f"index entry {key} -> {bid} outlives its block"


def supports_padded_prefill(cfg: ModelConfig) -> bool:
    """Bucketed (right-padded) prefill is exact only when every layer is
    global attention (pad tokens are causally ahead and later masked)."""
    return (
        cfg.family == "dense"
        and cfg.mixer == "attention"
        and cfg.sliding_window is None
        and cfg.moe is None
    )
