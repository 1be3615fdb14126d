"""Schedule -> kernel tiles: the paper's blocking search picks GEMM tiles.

The port's copy of the HBM<->VMEM part of the reference's
``core/mapper.py``: `choose_matmul_tiles()` runs the blocking search on a
2-level hierarchy (VMEM capacity, HBM unbounded) and rounds the winning
tile to the TPU's alignment (8 sublanes x 128 lanes, 128x128 MXU), exactly
as the reference does.  The port's contiguous decode split takes its KV
block from it (``kernels/flash_attention/ops.py``), as the reference's
does.  A Hopper-aligned GEMM tile search and the mesh-scale pricing wait
for the port's GEMM tuning and its parallel layer.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from pathlib import Path

from repro_torch.core import energy as en
from repro_torch.core.blocking import search_blocking
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.jsonstore import atomic_write_json, load_json_dict
from repro_torch.core.loopnest import matmul_nest
from repro_torch.core.schedule import ArraySpec, MemLevel

MXU_DIM = 128
SUBLANES = 8
LANES = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def round_down_pow2(x: int, lo: int) -> int:
    p = lo
    while p * 2 <= x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class MatmulTiles:
    """HBM->VMEM blocking for an (M, N, K) matmul: bm/bn/bk block sizes."""

    bm: int
    bn: int
    bk: int

    def vmem_bytes(self, dtype_bytes: int = 2) -> int:
        # A tile + B tile + accumulator tile (fp32), double-buffered operands
        return (
            2 * (self.bm * self.bk + self.bk * self.bn) * dtype_bytes
            + self.bm * self.bn * 4
        )


# ------------------------------------------------------ tile-choice cache --
# Two layers: functools.lru_cache in-process, plus an on-disk JSON store so
# serving/tests across processes never re-run the blocking search for a
# shape already solved.  The port keeps its own store, apart from the
# reference's: ``build/repro_torch/tpu_matmul_tiles.json`` in the checkout
# by default, elsewhere with REPRO_TORCH_TILE_CACHE (set it to an empty
# string to disable persistence).

_TILE_CACHE_ENV = "REPRO_TORCH_TILE_CACHE"
_TILE_CACHE_DEFAULT = str(
    Path(__file__).resolve().parents[3] / "build" / "repro_torch"
    / "tpu_matmul_tiles.json"
)
# Bump whenever the search or alignment logic changes, so stale entries from
# an older algorithm are never served (the key embeds this token).
_TILE_CACHE_SCHEMA = "v1"


def _tile_cache_path() -> str | None:
    path = os.environ.get(_TILE_CACHE_ENV, _TILE_CACHE_DEFAULT)
    return path or None


def _store_tile(path: str, key: str, t: MatmulTiles) -> None:
    """Read-merge-replace so concurrent processes lose at most one entry;
    the rename keeps the file always parseable."""
    data = load_json_dict(path)
    data[key] = [t.bm, t.bn, t.bk]
    try:
        atomic_write_json(path, data)
    except OSError:
        pass  # cache is best-effort; the search result is still returned


def _valid_cached_tile(
    t: MatmulTiles, M: int, N: int, K: int, vmem_bytes: int, dtype_bytes: int
) -> bool:
    """A cache entry is only served if it could have come out of the search:
    positive tile sides, (SUBLANES, LANES) hardware alignment, no side
    larger than the padded problem, and a double-buffered working set that
    fits the VMEM budget.  Anything else — a corrupt file, a stale schema
    that slipped through the key, a hand-edited entry — would otherwise be
    handed straight to every decode GEMM as a Pallas BlockSpec (``bm=0``
    divides by zero inside the kernel grid; a misaligned or oversized tile
    fails lowering or silently spills)."""
    if not all(
        isinstance(v, int) and v > 0 for v in (t.bm, t.bn, t.bk)
    ):
        return False
    if t.bm % SUBLANES or t.bn % LANES or t.bk % LANES:
        return False
    if (
        t.bm > round_up(M, SUBLANES)
        or t.bn > round_up(N, LANES)
        or t.bk > round_up(K, LANES)
    ):
        return False
    if t.vmem_bytes(dtype_bytes) > vmem_bytes:
        # the minimal aligned tile is servable even when a degenerate
        # vmem budget can't fit it — the search itself can do no better,
        # and rejecting it would re-search (and re-store) forever
        return (t.bm, t.bn, t.bk) == (SUBLANES, LANES, LANES)
    return True


@functools.lru_cache(maxsize=512)
def choose_matmul_tiles(
    M: int,
    N: int,
    K: int,
    vmem_bytes: int = en.TPU_VMEM_BYTES // 4,
    dtype_bytes: int = 2,
) -> MatmulTiles:
    """Blocking-search-backed tile choice, aligned to MXU/VREG geometry.

    Runs the paper's blocking search on the (VMEM, HBM) 2-level hierarchy of
    the matmul nest, then aligns the winning tile to (8, 128) register tiling
    and the 128x128 MXU.  Falls back to a bandwidth-balanced analytic tile
    for degenerate shapes.  Results persist to an on-disk cache keyed by
    (M, N, K, vmem_bytes, dtype_bytes) — see REPRO_TILE_CACHE above — with
    the lru_cache as the in-process layer.  Cached values are validated
    (positivity, sublane/lane alignment, VMEM fit) before being served; a
    corrupt or stale entry falls back to the search and is overwritten.
    """
    path = _tile_cache_path()
    key = f"{_TILE_CACHE_SCHEMA}:{M},{N},{K},{vmem_bytes},{dtype_bytes}"
    if path:
        got = load_json_dict(path).get(key)
        if isinstance(got, (list, tuple)) and len(got) == 3:
            try:
                t = MatmulTiles(bm=int(got[0]), bn=int(got[1]), bk=int(got[2]))
            except (TypeError, ValueError):
                t = None
            if t is not None and _valid_cached_tile(
                t, M, N, K, vmem_bytes, dtype_bytes
            ):
                return t
        # fall through: the search result below overwrites the bad entry
    t = _search_matmul_tiles(M, N, K, vmem_bytes, dtype_bytes)
    if path:
        _store_tile(path, key, t)
    return t


def _search_matmul_tiles(
    M: int, N: int, K: int, vmem_bytes: int, dtype_bytes: int
) -> MatmulTiles:
    # Pad tiny dims up to hardware alignment before searching.
    Mp, Np, Kp = round_up(M, SUBLANES), round_up(N, LANES), round_up(K, LANES)
    nest = matmul_nest("mm", M=Mp, N=Np, K=Kp)
    levels = (
        MemLevel("VMEM", capacity_bytes=vmem_bytes, double_buffered=True),
        MemLevel("HBM", capacity_bytes=None),
    )
    try:
        res = search_blocking(
            nest, levels, ArraySpec(dims=(1,)),
            Dataflow(assigns=((),)), beam=12,
        )
        tile = res.best.schedule.cum_tile(0, include_spatial=False)
        bm, bn, bk = tile["M"], tile["N"], tile["K"]
    except ValueError:
        bm, bn, bk = MXU_DIM, MXU_DIM, MXU_DIM
    # Hardware alignment: sublane/lane multiples, MXU-friendly, clamp to dim.
    bm = min(Mp, max(SUBLANES, round_down_pow2(bm, SUBLANES)))
    bn = min(Np, max(LANES, round_down_pow2(bn, LANES)))
    bk = min(Kp, max(LANES, round_down_pow2(bk, LANES)))
    t = MatmulTiles(bm=bm, bn=bn, bk=bk)

    # Shrink (bm first, then bn/bk) until the working set fits, keeping the
    # hardware alignment the cache validator enforces (halving 24 -> 12
    # would break the SUBLANES multiple).
    def _half(v: int, align: int) -> int:
        return max(align, (v // 2) // align * align)

    while t.vmem_bytes(dtype_bytes) > vmem_bytes and t.bm > SUBLANES:
        t = MatmulTiles(bm=_half(t.bm, SUBLANES), bn=t.bn, bk=t.bk)
    while t.vmem_bytes(dtype_bytes) > vmem_bytes and t.bk > LANES:
        t = MatmulTiles(bm=t.bm, bn=t.bn, bk=_half(t.bk, LANES))
    while t.vmem_bytes(dtype_bytes) > vmem_bytes and t.bn > LANES:
        t = MatmulTiles(bm=t.bm, bn=_half(t.bn, LANES), bk=t.bk)
    return t
