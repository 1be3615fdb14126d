"""Schedule -> kernel tiles: the paper's blocking search picks GEMM tiles.

The port's copy of the HBM<->VMEM part of the reference's
``core/mapper.py``: `choose_matmul_tiles()` runs the blocking search on a
2-level hierarchy (VMEM capacity, HBM unbounded) and rounds the winning
tile to the TPU's alignment (8 sublanes x 128 lanes, 128x128 MXU), exactly
as the reference does.  The port's contiguous decode split takes its KV
block from it (``kernels/flash_attention/ops.py``), as the reference's
does, and the serve planner's TPU description prices its decode GEMMs with
it (``MatmulTiles.hbm_words``).  The mesh-scale pricing waits for the
port's parallel layer.
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

    def hbm_words(self, M: int, N: int, K: int) -> int:
        """HBM<->VMEM traffic (words) of an (M, N, K) matmul blocked at
        these tiles: A streams once per N-tile pass, B once per M-tile
        pass, C is written once (the K loop accumulates in VMEM).  With a
        serving-sized M <= bm the weight matrix B crosses HBM exactly once
        — the quantity the decode-step planner (core/serveplan.py) prices.
        """
        n_m = -(-M // self.bm)
        n_n = -(-N // self.bn)
        return M * K * n_n + K * N * n_m + M * N


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


# --------------------------------------------------------------- mesh scale --


@dataclasses.dataclass(frozen=True)
class MeshDataflow:
    """Assignment of model loops to mesh axes = pod-scale spatial unrolling.

    axes: mesh axis name -> tuple of (loop name, shard factor), nearest-first
    (replication at pod scale, e.g. ('batch', 8)('seq', 2) on 'data').
    """

    axes: tuple[tuple[str, tuple[tuple[str, int], ...]], ...]

    def label(self) -> str:
        return " | ".join(
            f"{ax}:" + ("".join(d for d, _ in loops) or "-")
            for ax, loops in self.axes
        )


@dataclasses.dataclass(frozen=True)
class MeshHardware:
    """One chip of a mesh as the pod-scale roofline sees it: its compute
    peak, HBM rate, and the links a collective's bytes leave it by."""

    name: str
    peak_flops: float
    hbm_bytes_per_s: float
    link_bytes_per_s: float
    links: int

    @classmethod
    def h100(cls) -> "MeshHardware":
        """The default: the H100 (``repro_torch/hw.py``), dense bf16, HBM3,
        NVLink 4's 18 links at 25 GB/s each way."""
        from repro_torch import hw

        return cls(name="h100-sxm", peak_flops=hw.BF16_FLOPS_PER_S,
                   hbm_bytes_per_s=hw.HBM_BYTES_PER_S,
                   link_bytes_per_s=hw.NVLINK_BYTES_PER_S_PER_LINK, links=hw.NVLINK_LINKS)

    @classmethod
    def tpu_v5e(cls) -> "MeshHardware":
        """The reference's v5e constants (197 TFLOP/s, 819 GB/s, 50 GB/s a
        link over 2 ICI links).  Not this card."""
        return cls(name="tpu-v5e", peak_flops=en.TPU_PEAK_FLOPS_BF16,
                   hbm_bytes_per_s=en.TPU_HBM_BYTES_PER_S,
                   link_bytes_per_s=en.TPU_ICI_BYTES_PER_S_PER_LINK, links=2)


def mesh_dataflow_cost(
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    n_chips: int,
    ici_links: int | None = None,
    hardware: MeshHardware | None = None,
) -> dict[str, float]:
    """The paper's E = sum acc_i * e_i at pod scale, in seconds: the three
    roofline terms (compute / memory / collective) on ``hardware`` (the
    H100 unless given); ``ici_links`` overrides its link count."""
    hardware = hardware or MeshHardware.h100()
    links = hardware.links if ici_links is None else ici_links
    return {
        "compute_s": flops / (n_chips * hardware.peak_flops),
        "memory_s": hbm_bytes / (n_chips * hardware.hbm_bytes_per_s),
        "collective_s": collective_bytes
        / (n_chips * links * hardware.link_bytes_per_s),
    }


def dominant_term(cost: dict[str, float]) -> str:
    return max(cost, key=lambda k: cost[k])
