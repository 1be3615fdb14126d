"""The linear-scan kernels: CUDA wrappers and their plain versions.

:func:`linear_scan_cuda` replaces the TPU kernel ``linear_scan_pallas``
(``repro/kernels/linear_scan/linear_scan.py``, the RG-LRU's diagonal
recurrence ``h_t = a_t * h_{t-1} + x_t``) with
``kernels/csrc/linear_scan.cu``: one thread per (batch row, channel) runs
the chain, ``h`` in a register for all T.  Up to :data:`SCAN_STEP_MAX_T`
steps (decode) the step body gives a thread 4 channels in 16-byte
vectors and one memory round trip; beyond, the ring body gives one warp
32 channels of a row and a 96 KB shared-memory ring of stages of 64 or
128 steps, filled ahead of the chain by TMA or by ``cp.async``
(:func:`scan_plan`, mirrored by the kernel's own ``linear_scan_plan``).
It takes fp32 ``(B, T, D)`` tensors
whose last axis is contiguous (any row and step strides, any base) and
raises on anything else.  Each step is one rounded multiply and one
rounded add, as in its plain version :func:`linear_scan_plain` (the
reference's step loop, ``ref.linear_scan_ref``), so the two are bitwise
equal on the card in every body.  With ``inplace`` the final state
overwrites ``h0`` (the serve cache's ``h``).

:func:`wkv6_cuda` replaces the TPU kernel ``wkv6_pallas`` (same file) with
``kernels/csrc/wkv6.cu``: a block per 16 value columns (32 below 16
steps) of a (batch row, head), each thread holding 2 key rows x 4 value columns of the (Dk, Dv)
fp32 state in registers across all T steps, r, k, w and v staged through a
``cp.async`` ring (one step reads its operands directly), and every
output's sum over the key index in an order fixed by Dk alone
(:func:`wkv_plan`, mirrored by the kernel's own ``wkv6_plan``), so a row's
bits do not depend on B, H or the grid. It takes fp32 tensors with key and
value head sizes Dk and Dv each in :data:`HEAD_SIZES`, independently, as
``wkv6_pallas`` does, and raises on anything else. r, k and w may be any
(B, H, T, Dk) views that share one layout with a contiguous last axis, v
any dense (B, H, T, Dv) view with a contiguous last axis (the model passes
its (B, T, H, 64) activations transposed, with no copy); the output comes
back in v's layout. With ``inplace`` the final state overwrites ``s0``
(the serve cache's state), which the kernel can do because each block owns
its state alone.
:func:`wkv6_plain` is its plain version: the reference's per-step einsum
(``ref.wkv6_ref``).

Each wrapper runs its plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import hw
from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan.ref import linear_scan_ref, wkv6_ref

HEAD_SIZES = (16, 32, 64)  # the kernel's Dk and Dv (RWKV-6 heads are 64 wide)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "wkv6_fp32": [_P] * 8 + [_I] * 5 + [_L] * 6 + [_P],
    "wkv6_plan": [_P] * 7 + [_I] * 5 + [_L] * 6 + [_P],
}
_SCAN_SIGS = {
    "linear_scan_fp32": [_P] * 5 + [_I] * 3 + [_L] * 6 + [_P],
    "linear_scan_plan": [_P] * 5 + [_I] * 3 + [_L] * 6 + [_P],
}

# The scan's constants (``csrc/linear_scan.cu``, which mirrors them)
SCAN_STEP_MAX_T = 8       # the step body up to here, the ring body beyond
SCAN_STEP_THREADS = 128
SCAN_CT = 32              # channels a ring block: one 128-byte row a step
SCAN_LONG_T = 65          # ring stages of 128 steps from here, one of 64 below
SCAN_RING_BYTES = 6 * 2 * 64 * SCAN_CT * 4  # 96 KB a block
SCAN_BODIES = ("step4", "step1", "ring_tma", "ring_copy")

# WKV-6's constants (``csrc/wkv6.cu``, which mirrors them)
WKV_COLS = 16             # value columns a block from WKV_CHUNK steps on
WKV_SHORT_COLS = 32       # below, where Dv allows: whole 128-byte state lines
WKV_QUAD = 4              # value columns a thread
WKV_ROWS = 2              # key rows a thread
WKV_CHUNK = 16            # steps a ring stage at most
WKV_STAGES = 4


def resident_blocks(grid: int, threads: int, smem: int, regs: int = 0) -> int:
    """Blocks of a launch the card holds at once: the SMs times what one
    SM holds by threads, shared memory, registers (``regs`` a thread, if
    given) and its block limit."""
    per_sm = min(hw.BLOCKS_PER_SM, hw.THREADS_PER_SM // threads,
                 hw.SMEM_PER_SM_BYTES // (smem + hw.SMEM_RESERVED_PER_BLOCK_BYTES))
    if regs:
        per_sm = min(per_sm, hw.REGISTERS_PER_SM // (regs * threads))
    return min(grid, hw.SM_COUNT * per_sm)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _layout(t: torch.Tensor) -> tuple[int, ...]:
    """Strides of the axes that have more than one element: the kernel
    never steps along the others, so their strides do not matter."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape, t.stride()))


# ------------------------------------------------------------ diagonal scan


def linear_scan_plain(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, inplace: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    out, hT = linear_scan_ref(a, x, h0)
    if inplace:
        hT = h0.copy_(hT)
    return out, hT


def _check_scan(a, x, h0) -> tuple[int, int, int]:
    """Raise on what the scan kernel does not take; returns (B, T, D)."""
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in (x, h0)):
        raise ValueError("linear_scan needs every operand on one CUDA device: "
                         f"{[str(t.device) for t in (a, x, h0)]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if any(t.dtype != torch.float32 for t in (a, x, h0)):
        raise ValueError(f"kernel takes fp32 operands, got {[t.dtype for t in (a, x, h0)]}")
    if a.ndim != 3 or x.shape != a.shape:
        raise ValueError(f"a and x must be one (B, T, D) shape: {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    B, T, D = a.shape
    if h0.shape != (B, D):
        raise ValueError(f"h0 must be ({B}, {D}): {tuple(h0.shape)}")
    if D > 1 and (a.stride(2) != 1 or x.stride(2) != 1 or h0.stride(1) != 1):
        raise ValueError(f"the channel axis must be contiguous: strides {a.stride()}, "
                         f"{x.stride()}, {h0.stride()}")
    return B, T, D


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The scan kernel's launch: body (:data:`SCAN_BODIES`), grid (x, y),
    threads a block, steps a ring stage, ring stages (both 0 in the step
    body) and dynamic shared memory in bytes."""

    body: str
    grid: tuple[int, int]
    threads: int
    steps: int
    stages: int
    smem: int

    def as_ints(self) -> tuple[int, ...]:
        """As the kernel's ``linear_scan_plan`` reports it."""
        return (SCAN_BODIES.index(self.body), *self.grid, self.threads, self.steps,
                self.stages, self.smem)

    def in_flight(self, B: int, T: int, D: int) -> int:
        """Bytes of a and x the card has requested and not yet consumed at
        the steady state: the step body issues all of its loads at once;
        each resident ring block keeps its stages in flight."""
        if self.body.startswith("step"):
            return 4 * B * D * (2 * T + 1)
        blocks = resident_blocks(self.grid[0] * self.grid[1], self.threads, self.smem)
        return blocks * self.stages * scan_stage_bytes(self.steps)


def scan_stage_bytes(steps: int) -> int:
    """Bytes of a ring stage: ``steps`` steps of a and x for 32 channels."""
    return 2 * steps * SCAN_CT * 4


def scan_eligibility(a, x, h0, out, hT) -> tuple[bool, bool]:
    """(16-byte vectors for the step body, TMA for the ring body), as the
    kernel decides them from the pointers and the strides it is given."""
    B, T, D = a.shape
    (sa_b, sa_t, _), (sx_b, sx_t, _) = _layout(a), _layout(x)
    streams = (_aligned(a) and _aligned(x)
               and all(s % 4 == 0 for s in (sa_b, sa_t, sx_b, sx_t)))
    step_vec = (streams and D % 4 == 0 and _aligned(h0) and _aligned(hT) and _aligned(out)
                and _layout(h0)[0] % 4 == 0 and _layout(hT)[0] % 4 == 0)
    # a box may reach past D and T (TMA fills zeros); a broadcast axis
    # (stride 0 over several elements) has no tensor map
    ring_tma = streams and sa_t > 0 and sx_t > 0 and (B == 1 or (sa_b > 0 and sx_b > 0))
    return step_vec, ring_tma


def scan_plan(B: int, T: int, D: int, step_vec: bool, ring_tma: bool) -> ScanPlan:
    """The scan kernel's plan (``csrc/linear_scan.cu``'s ``scan_plan``
    mirrors it): the step body up to :data:`SCAN_STEP_MAX_T` steps, one
    thread per 4 channels (``step4``) or per channel (``step1``), a row of
    128-thread blocks per batch row; beyond, the ring body, one 32-thread
    block per (row, 32 channels) with a 96 KB ring of stages of 128 steps
    of a and x from :data:`SCAN_LONG_T` steps on (3 stages), else one of
    64, and no more stages than T fills."""
    if T <= SCAN_STEP_MAX_T:
        v = 4 if step_vec else 1
        return ScanPlan("step4" if step_vec else "step1",
                        (-(-(D // v) // SCAN_STEP_THREADS), B), SCAN_STEP_THREADS, 0, 0, 0)
    steps = 128 if T >= SCAN_LONG_T else 64
    stages = min(SCAN_RING_BYTES // scan_stage_bytes(steps), -(-T // steps))
    return ScanPlan("ring_tma" if ring_tma else "ring_copy", (-(-D // SCAN_CT), B), 32, steps,
                    stages, stages * scan_stage_bytes(steps) + 8 * stages)


def _scan_args(a, x, h0, out, hT) -> tuple:
    B, T, D = a.shape
    return (a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), hT.data_ptr(),
            B, T, D, a.stride(0), a.stride(1), x.stride(0), x.stride(1),
            h0.stride(0), hT.stride(0))


def scan_kernel_plan(a, x, h0, out, hT) -> tuple[int, ...]:
    """The kernel's own plan for these operands (``linear_scan_plan``), as
    :meth:`ScanPlan.as_ints` gives it; needs the built library."""
    res = (ctypes.c_int * 7)()
    lib = _build.library("linear_scan", _SCAN_SIGS)
    _build.check(lib.linear_scan_plan(*_scan_args(a, x, h0, out, hT), res), "linear_scan_plan")
    return tuple(res)


def linear_scan_cuda(
    a: torch.Tensor,   # (B, T, D) fp32 decay
    x: torch.Tensor,   # (B, T, D) fp32 input
    h0: torch.Tensor,  # (B, D) fp32 state
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, T, D) contiguous, h_T (B, D)); with ``inplace``, h_T is
    ``h0`` updated in place."""
    if all(t.device.type == "cpu" for t in (a, x, h0)):
        return linear_scan_plain(a, x, h0, inplace=inplace)
    B, T, D = _check_scan(a, x, h0)
    out = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    hT = h0 if inplace else torch.empty_like(h0)
    if B * D == 0:
        return out, hT
    lib = _build.library("linear_scan", _SCAN_SIGS)
    err = lib.linear_scan_fp32(*_scan_args(a, x, h0, out, hT),
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "linear_scan_fp32")
    linear_scan_cuda.launches += 1
    return out, hT


linear_scan_cuda.launches = 0


# ------------------------------------------------------------------- WKV-6


def wkv6_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, s0: torch.Tensor, *, inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    out, sT = wkv6_ref(r, k, v, w, u, s0)
    if inplace:
        sT = s0.copy_(sT)
    return out, sT


def _check(r, k, v, w, u, s0) -> tuple[int, int, int, int, int]:
    """Raise on what the kernel does not take; returns (B, H, T, Dk, Dv)."""
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, w, u, s0)):
        raise ValueError("wkv6 needs every operand on one CUDA device: "
                         f"{[str(t.device) for t in (r, k, v, w, u, s0)]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {dev}, not the current CUDA device")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, s0)):
        raise ValueError("kernel takes fp32 operands, got "
                         f"{[t.dtype for t in (r, k, v, w, u, s0)]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, w)):
        raise ValueError(f"r, k, w must be one (B, H, T, Dk) shape: "
                         f"{[tuple(t.shape) for t in (r, k, w)]}")
    B, H, T, Dk = r.shape
    if v.ndim != 4 or v.shape[:3] != (B, H, T):
        raise ValueError(f"v must be ({B}, {H}, {T}, Dv): {tuple(v.shape)}")
    Dv = v.shape[3]
    if Dk not in HEAD_SIZES or Dv not in HEAD_SIZES:
        raise ValueError(f"kernel takes key and value head sizes in {HEAD_SIZES}, "
                         f"got Dk={Dk}, Dv={Dv}")
    if r.stride(3) != 1 or any(_layout(t) != _layout(r) for t in (k, w)):
        raise ValueError(f"r, k, w must share strides with a contiguous last axis: "
                         f"{[t.stride() for t in (r, k, w)]}")
    if v.stride(3) != 1:
        raise ValueError(f"v's last axis must be contiguous: strides {v.stride()}")
    if u.shape != (H, Dk) or not u.is_contiguous():
        raise ValueError(f"u must be contiguous ({H}, {Dk}): {tuple(u.shape)}")
    if s0.shape != (B, H, Dk, Dv) or not s0.is_contiguous():
        raise ValueError(f"s0 must be contiguous ({B}, {H}, {Dk}, {Dv}): {tuple(s0.shape)}")
    return B, H, T, Dk, Dv


@dataclasses.dataclass(frozen=True)
class WkvPlan:
    """The WKV-6 kernel's launch: copy and state vector width in floats
    (4 or 1), steps a thread runs at once (4 where a stage holds 16 steps,
    else 1), value columns a block, blocks, threads a block, steps a ring
    stage and dynamic shared memory in bytes."""

    vec: int
    unroll: int
    cols: int
    grid: int
    threads: int
    chunk: int
    smem: int

    @property
    def max_regs(self) -> int:
        """The one-step-at-a-time instances' launch bound: 64 registers a
        thread, so that 1024 threads share an SM; the others have none (0)."""
        return hw.REGISTERS_PER_SM // 1024 if self.unroll == 1 else 0

    def as_ints(self) -> tuple[int, ...]:
        """As the kernel's ``wkv6_plan`` reports it."""
        return (self.vec, self.unroll, self.cols, self.grid, self.threads, self.chunk, self.smem)

    def in_flight(self, Dk: int, T: int) -> int:
        """Bytes of r, k, w and v the resident blocks have requested ahead
        of the chunk they work on (up to three ring stages each)."""
        ahead = min(WKV_STAGES - 1, -(-T // self.chunk))
        blocks = resident_blocks(self.grid, self.threads, self.smem, self.max_regs)
        return blocks * ahead * self.chunk * 4 * wkv_row_floats(Dk, self.cols)


def wkv_row_floats(Dk: int, cols: int) -> int:
    """Floats a step takes in a ring stage: the r, k and w rows and the
    block's ``cols`` values of v."""
    return 3 * Dk + cols


def wkv_part_floats(Dk: int, cols: int) -> int:
    """Floats a step takes in the partial buffer: Dk / 2 partials of
    ``cols`` columns and one row of padding."""
    return (Dk // WKV_ROWS + 1) * cols


def wkv_plan(B: int, H: int, T: int, Dk: int, Dv: int, vec: bool) -> WkvPlan:
    """The WKV-6 kernel's plan (``csrc/wkv6.cu``'s ``wkv_plan`` mirrors
    it): one block of Dk x cols / 8 threads per ``cols`` value columns of a
    (row, head) -- 16, or 32 below 16 steps where Dv allows -- a ring of 4
    stages of min(T, 16) steps beside the step partials (one step reads
    its operands without the ring), 4 steps a thread at once where a stage
    holds 16."""
    chunk = max(1, min(T, WKV_CHUNK))
    cols = WKV_COLS if T >= WKV_CHUNK or Dv < WKV_SHORT_COLS else WKV_SHORT_COLS
    smem = 4 * chunk * (WKV_STAGES * wkv_row_floats(Dk, cols) + wkv_part_floats(Dk, cols))
    return WkvPlan(4 if vec else 1, 4 if chunk == WKV_CHUNK else 1, cols, B * H * (Dv // cols),
                   Dk // WKV_ROWS * (cols // WKV_QUAD), chunk, smem)


def _wkv_strides(r, v) -> tuple[int, ...]:
    """(sb, sh, st, vsb, vsh, vst) as the kernel takes them: 0 for an axis
    of one element, which it never steps along."""
    return _layout(r)[:3] + _layout(v)[:3]


def wkv_vec_ok(r, k, v, w, s0, o, sT) -> bool:
    """16-byte copies and state vectors, as the kernel decides them: every
    pointer a multiple of 16 bytes and every stride of 4 elements."""
    return (all(_aligned(t) for t in (r, k, v, w, s0, o, sT))
            and all(st % 4 == 0 for st in _wkv_strides(r, v)))


def wkv_kernel_plan(r, k, v, w, s0, o, sT) -> tuple[int, ...]:
    """The kernel's own plan for these operands (``wkv6_plan``), as
    :meth:`WkvPlan.as_ints` gives it; needs the built library."""
    B, H, T, Dk = r.shape
    res = (ctypes.c_int * 7)()
    lib = _build.library("wkv6", _SIGS)
    _build.check(lib.wkv6_plan(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                               s0.data_ptr(), o.data_ptr(), sT.data_ptr(), B, H, T, Dk,
                               v.shape[3], *_wkv_strides(r, v), res), "wkv6_plan")
    return tuple(res)


def wkv6_cuda(
    r: torch.Tensor,   # (B, H, T, Dk) fp32
    k: torch.Tensor,   # (B, H, T, Dk)
    v: torch.Tensor,   # (B, H, T, Dv)
    w: torch.Tensor,   # (B, H, T, Dk) decay in (0, 1)
    u: torch.Tensor,   # (H, Dk) bonus
    s0: torch.Tensor,  # (B, H, Dk, Dv)
    *,
    inplace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (out (B, H, T, Dv) in v's layout, s_T (B, H, Dk, Dv)); with
    ``inplace``, s_T is ``s0`` updated in place."""
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, s0)):
        return wkv6_plain(r, k, v, w, u, s0, inplace=inplace)
    B, H, T, Dk, Dv = _check(r, k, v, w, u, s0)
    out = torch.empty_like(v)
    if _layout(out) != _layout(v):
        raise ValueError(f"v must be dense (strides {v.stride()})")
    sT = s0 if inplace else torch.empty_like(s0)
    if B * H == 0:
        return out, sT
    lib = _build.library("wkv6", _SIGS)
    err = lib.wkv6_fp32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), sT.data_ptr(), B, H, T, Dk, Dv,
        *_wkv_strides(r, v), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, "wkv6_fp32")
    wkv6_cuda.launches += 1
    return out, sT


wkv6_cuda.launches = 0
