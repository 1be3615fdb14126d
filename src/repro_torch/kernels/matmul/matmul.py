"""GEMM: the CUDA kernel wrappers, their plan and their plain versions.

:func:`matmul_cuda` replaces the TPU kernel ``matmul_pallas``
(``repro/kernels/matmul/matmul.py``) with ``kernels/csrc/matmul.cu``: fp32
accumulation, stored in the operands' type, ragged edges masked inside
the kernel (no padding copies), and B taken as ``(K, N)`` or, with
``trans_b``, as ``(N, K)`` so the tied unembedding reads the embedding
table in place.  bf16 operands run on the tensor cores (a TMA ring
feeding ``wgmma``, the weight as the MMA's 64-row side); fp32 operands on
the CUDA cores in full fp32 (no TF32).  In both types a row's bits do not
depend on M: the bf16 bodies sum every output over the same chunks of K,
in the same order, at every M (:func:`plan`).

:func:`plan` is the bf16 bodies' launch plan, mirrored by the kernel's
own (``gemm_plan``): the skinny body up to 64 rows (one consumer
warpgroup, K split across a thread-block cluster), the wide body beyond
(a persistent block per SM, two consumer warpgroups), the K split from
(N, K) alone, and the rest keyed on an M bucket, never on the exact M.

:func:`matmul_plain` is its plain version: the fp32 product cast to the
input dtype (the reference's ``matmul_ref``).  The wrapper runs it only
for CPU tensors; a CUDA tensor launches the kernel or raises.

:func:`matmul_abft_cuda` replaces ``matmul_pallas_abft`` with the same
kernel plus a checksum epilogue (``gemm_abft``): it also returns the
column sums ``e^T·C`` of every row block of :func:`abft_block_rows` rows,
summed from the fp32 accumulator before the cast, as a
``(ceil(M/bm), N)`` fp32 tensor.  Its product is bitwise
:func:`matmul_cuda`'s.  :func:`matmul_abft_plain` is its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import hw
from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "gemm": [_P] * 3 + [_I] * 5 + [_P],
    "gemm_abft": [_P] * 4 + [_I] * 5 + [_P],
    "gemm_plan": [_I] * 4 + [_P],
}
DTYPES = (torch.bfloat16, torch.float32)

# The bf16 bodies' constants (``csrc/matmul.cu``, which mirrors them)
PANEL_K = 64            # k a ring stage: one 128-byte swizzle span of bf16
TILE_N = 64             # output columns a consumer warpgroup (wgmma's 64 rows)
SKINNY_MAX_M = 64       # the skinny body up to here, the wide body beyond
MAX_SPLIT = 8           # K chunks at most: the portable cluster size
SKINNY_MAX_STAGES = 8
WIDE_MAX_STAGES = 8
WIDE_BM = 128           # M rows a wide tile
MAX_BUCKET = 16384      # M buckets stop growing here
SMEM_LIMIT = 232_448    # 227 KB a block
STG_LD = 68             # fp32 staging row: 64 columns + 4 (no bank conflicts)
W_BOX_BYTES = TILE_N * PANEL_K * 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bf16 kernel runs one call: ``body`` "skinny" or "wide",
    ``bm`` M rows a tile (wgmma's N), ``bn`` output columns a tile, K in
    ``split`` chunks, a ring of ``stages``, ``grid`` blocks and ``smem``
    bytes of dynamic shared memory a block."""

    body: str
    bm: int
    bn: int
    split: int
    stages: int
    grid: int
    smem: int

    def as_ints(self) -> tuple[int, ...]:
        """The plan as the kernel's ``gemm_plan`` writes it."""
        return (int(self.body == "wide"), self.bm, self.bn, self.split, self.stages,
                self.grid, self.smem)


def m_bucket(M: int) -> int:
    """The M bucket a plan is keyed on: 8, 16, 32 or 64 up to 64 rows (the
    skinny body's tile), then M rounded up to the wide tile's 128 rows, at
    most ``MAX_BUCKET``."""
    if M > SKINNY_MAX_M:
        return min(-(-M // WIDE_BM) * WIDE_BM, MAX_BUCKET)
    b = 8
    while b < M:
        b *= 2
    return b


def wide_bn(bucket: int, N: int) -> int:
    """The wide body's tile columns: 128 (the two consumer warpgroups split
    the columns) or 64 (they split the 128 rows), whichever takes less time
    as L2 serves it: rounds of tiles over the card's SMs times the bytes
    a block loads for each 64-k panel (the wide body is bound by L2's rate
    to the SMs)."""
    mt = -(-bucket // WIDE_BM)
    t128 = -(-(-(-N // (2 * TILE_N)) * mt) // hw.SM_COUNT) * (2 * W_BOX_BYTES + WIDE_BM * 128)
    t64 = -(-(-(-N // TILE_N) * mt) // hw.SM_COUNT) * (W_BOX_BYTES + WIDE_BM * 128)
    return TILE_N if t64 < t128 else 2 * TILE_N


def wide_rows(bn: int) -> int:
    """Rows a wide consumer warpgroup multiplies (wgmma's N) at ``bn``
    tile columns."""
    return WIDE_BM // 2 if bn == TILE_N else WIDE_BM


def split_time(N: int, K: int, split: int) -> int:
    """The skinny grid's time at ``split`` chunks, in 64-k panels: its waves
    over the card's SMs times the longest chunk's panels."""
    kp, nt = -(-K // PANEL_K), -(-N // TILE_N)
    return -(-nt * split // hw.SM_COUNT) * -(-kp // split)


def k_split(N: int, K: int) -> int:
    """K chunks, from (N, K) alone: the split whose :func:`split_time` is
    least, the fewest chunks among equals; at most ``MAX_SPLIT`` and the
    64-k panels.  ``ops.gemm_search`` (the blocking search on the GEMM
    nest) makes the same choice."""
    kp = -(-K // PANEL_K)
    splits = range(1, max(1, min(MAX_SPLIT, kp)) + 1)
    return min(splits, key=lambda s: (split_time(N, K, s), s))


def chunk_start(c: int, kp: int, split: int) -> int:
    """First 64-k panel of chunk ``c`` of ``split`` over ``kp`` panels."""
    return c * kp // split


@functools.lru_cache(maxsize=1024)
def _plan(bucket: int, N: int, K: int) -> Plan:
    kp, split = -(-K // PANEL_K), k_split(N, K)
    if bucket <= SKINNY_MAX_M:
        stages = max(1, min(SKINNY_MAX_STAGES, -(-kp // split)))
        smem = (1024 + stages * (W_BOX_BYTES + bucket * 128) + bucket * STG_LD * 4
                + (bucket * 256 if split > 1 else 0) + 16 * stages)
        return Plan("skinny", bucket, TILE_N, split, stages, -(-N // TILE_N) * split, smem)
    bm, bn = WIDE_BM, wide_bn(bucket, N)
    stage = bn // TILE_N * W_BOX_BYTES + bm * 128
    staging = 2 * wide_rows(bn) * STG_LD * 4
    fixed = 1024 + staging + 16 * WIDE_MAX_STAGES
    stages = min(WIDE_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    grid = min(hw.SM_COUNT, -(-N // bn) * -(-bucket // bm))
    smem = 1024 + stages * stage + staging + 16 * stages
    return Plan("wide", bm, bn, split, stages, grid, smem)


def plan(M: int, N: int, K: int, trans_b: bool = False) -> Plan:
    """The bf16 kernel's plan for an (M, K) @ (K, N) product (``trans_b``
    does not change it), keyed on :func:`m_bucket` (M) and cached:
    ``csrc/matmul.cu``'s ``plan`` mirrors it.  Up to 64 rows the skinny
    body: an M tile of the bucket's rows, one 64-column tile a block, the
    chunks of a tile on a cluster of ``split`` blocks, as many stages as a
    chunk has panels (at most 8).  Beyond, the wide body: 128 rows x
    :func:`wide_bn` columns a tile, as many stages as fit beside the staging
    tiles (at most 8), at most 132 persistent blocks."""
    del trans_b
    if M < 1 or N < 1 or K < 0:
        raise ValueError(f"gemm takes M, N >= 1 and K >= 0: {M}, {N}, {K}")
    return _plan(m_bucket(M), N, K)


def kernel_plan(M: int, N: int, K: int, trans_b: bool = False) -> tuple[int, ...]:
    """The kernel's own plan (``gemm_plan``) as :meth:`Plan.as_ints` gives it;
    needs the built library (the card's machine)."""
    out = (ctypes.c_int * 7)()
    lib = _build.library("matmul", _SIGS)
    _build.check(lib.gemm_plan(M, N, K, int(trans_b), out), "gemm_plan")
    return tuple(out)


def abft_block_rows(M: int) -> int:
    """Rows per checksum block: the kernel's row tile for this M."""
    return 16 if M <= 16 else 64


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    return matmul_ref(a, b.T if trans_b else b)


def matmul_abft_plain(
    a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`matmul_abft_cuda`: the fp32 product cast to
    the input dtype, and the column sums of the fp32 product over every
    :func:`abft_block_rows`-row block (the last block is ragged: missing
    rows add nothing)."""
    M = a.shape[0]
    bm = abft_block_rows(M)
    acc = a.float() @ (b.T if trans_b else b).float()
    nrb = -(-M // bm)
    padded = torch.nn.functional.pad(acc, (0, 0, 0, nrb * bm - M))
    return acc.to(a.dtype), padded.reshape(nrb, bm, -1).sum(1)


def _check_operands(a: torch.Tensor, b: torch.Tensor, trans_b: bool) -> tuple[int, int, int]:
    """Raise on what the GEMM kernels do not take; returns (M, N, K)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul needs both operands on one CUDA device: {a.device}, {b.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {a.device}, not the current CUDA device")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"kernel takes two bf16 or two fp32 operands, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"kernel takes contiguous 2-D operands: {a.shape}, {b.shape}")
    M, K = a.shape
    N, Kb = (b.shape if trans_b else b.shape[::-1])
    if K != Kb:
        raise ValueError(f"inner dims differ: a {a.shape}, b {b.shape}, trans_b={trans_b}")
    return M, N, K


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N), or (M, K) @ (N, K)^T with ``trans_b``, -> (M, N)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, trans_b=trans_b)
    M, N, K = _check_operands(a, b, trans_b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library("matmul", _SIGS)
    err = lib.gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(trans_b),
        int(a.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "gemm")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0


def matmul_abft_cuda(
    a: torch.Tensor, b: torch.Tensor, *, trans_b: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`matmul_cuda` plus the fp32 column checksums of every
    :func:`abft_block_rows`-row block: ``(out (M, N), checks (ceil(M/bm), N))``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_abft_plain(a, b, trans_b=trans_b)
    M, N, K = _check_operands(a, b, trans_b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    checks = torch.empty(
        (-(-M // abft_block_rows(M)), N), dtype=torch.float32, device=a.device
    )
    if M == 0 or N == 0:
        return out, checks
    lib = _build.library("matmul", _SIGS)
    err = lib.gemm_abft(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), checks.data_ptr(), M, N, K,
        int(trans_b), int(a.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "gemm_abft")
    matmul_abft_cuda.launches += 1
    return out, checks


matmul_abft_cuda.launches = 0
