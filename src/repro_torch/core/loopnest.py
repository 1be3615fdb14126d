"""Loop-nest IR: the paper's seven nested CONV loops, generalized.

The paper (§3) observes that every dense DNN accelerator computes the same
seven-deep loop nest

    for b, k, c, y, x, fy, fx:
        O[b][k][x][y] += I[b][c][x+fx][y+fy] * W[k][c][fx][fy]

and that the accelerator design space is exactly the space of loop
transformations (blocking/reorder/spatial-unroll) of this nest.  We represent
the nest as a set of named dims with bounds, plus per-tensor *projections*
(which dims index each tensor).  Sliding-window reuse (the x/fx and y/fy
coupling) is expressed as `coupled` dim pairs: the tensor's extent along the
base dim is `tile(x) + tile(fx) - 1` (stride handled at projection time).

FC layers, matmuls, attention contractions, and MoE expert matmuls are the
same nest with some bounds set to 1 (paper §3) or with renamed dims, so a
single IR covers the paper's CONV/FC benchmarks *and* the LM-framework ops
that the TPU mapper schedules.

The port's copy of the reference's ``core/loopnest.py``, without the
depthwise nest (MobileNet waits for the port's optimizer).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

# Canonical dim names for the 7-loop CONV nest (paper Algorithm 1).
CONV_DIMS = ("B", "K", "C", "Y", "X", "FY", "FX")


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """A tensor touched by the nest.

    dims:     dims that directly index the tensor (affine, stride-1 in tiles).
    coupled:  mapping base_dim -> (filter_dim, stride): tensor extent along
              base_dim is  stride*(tile_base-1) + tile_filter  (halo).
    output:   True if the tensor is accumulated into (reduction semantics).
    """

    name: str
    dims: tuple[str, ...]
    coupled: Mapping[str, tuple[str, int]] = dataclasses.field(default_factory=dict)
    output: bool = False

    @property
    def relevant(self) -> frozenset[str]:
        """Dims whose iteration changes which tensor elements are touched."""
        rel = set(self.dims)
        for base, (filt, _stride) in self.coupled.items():
            rel.add(base)
            rel.add(filt)
        return frozenset(rel)

    def key(self) -> tuple:
        """Hashable structural identity (name excluded): used by search memos
        so repeated layer shapes in a network are solved once."""
        return (
            self.dims,
            tuple(sorted(self.coupled.items())),
            self.output,
        )

    def tile_elems(self, tile: Mapping[str, int]) -> int:
        """Elements of this tensor needed for a given iteration-space tile."""
        n = 1
        handled: set[str] = set()
        for base, (filt, stride) in self.coupled.items():
            n *= stride * (tile.get(base, 1) - 1) + tile.get(filt, 1)
            handled.add(base)
            handled.add(filt)
        for d in self.dims:
            if d not in handled:
                n *= tile.get(d, 1)
        return n


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """A perfectly-nested dense contraction."""

    name: str
    bounds: Mapping[str, int]              # dim -> extent
    tensors: tuple[TensorRef, ...]
    reduction_dims: frozenset[str]         # dims summed over (irrelevant to O)

    def __post_init__(self):
        for t in self.tensors:
            for d in t.relevant:
                if d not in self.bounds:
                    raise ValueError(f"tensor {t.name} uses unknown dim {d}")
        outs = [t for t in self.tensors if t.output]
        if len(outs) != 1:
            raise ValueError("exactly one output tensor required")

    def key(self) -> tuple:
        """Hashable structural identity: nests with equal keys have identical
        search spaces and costs regardless of `name` (networks repeat layer
        shapes, so the optimizer's memo solves each shape once)."""
        return (
            tuple(self.bounds.items()),
            tuple(t.key() for t in self.tensors),
            tuple(sorted(self.reduction_dims)),
        )

    @property
    def dims(self) -> tuple[str, ...]:
        return tuple(self.bounds.keys())

    @property
    def output(self) -> TensorRef:
        return next(t for t in self.tensors if t.output)

    @property
    def inputs(self) -> tuple[TensorRef, ...]:
        return tuple(t for t in self.tensors if not t.output)

    def macs(self) -> int:
        """Total multiply-accumulates = product of all loop bounds."""
        return math.prod(self.bounds.values())

    def tensor(self, name: str) -> TensorRef:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)


def conv_nest(
    name: str,
    *,
    B: int,
    K: int,
    C: int,
    X: int,
    Y: int,
    FX: int,
    FY: int,
    stride: int = 1,
) -> LoopNest:
    """The paper's Algorithm-1 CONV nest.  X/Y are *output* extents."""
    bounds = {"B": B, "K": K, "C": C, "Y": Y, "X": X, "FY": FY, "FX": FX}
    I = TensorRef(
        "I",
        dims=("B", "C", "X", "Y", "FX", "FY"),
        coupled={"X": ("FX", stride), "Y": ("FY", stride)},
    )
    W = TensorRef("W", dims=("K", "C", "FX", "FY"))
    O = TensorRef("O", dims=("B", "K", "X", "Y"), output=True)
    return LoopNest(
        name=name,
        bounds=bounds,
        tensors=(I, W, O),
        reduction_dims=frozenset({"C", "FX", "FY"}),
    )


def fc_nest(name: str, *, B: int, C: int, K: int) -> LoopNest:
    """FC layer = CONV with X=Y=FX=FY=1 (paper §3): O[b,k] += I[b,c] W[k,c]."""
    return conv_nest(name, B=B, K=K, C=C, X=1, Y=1, FX=1, FY=1)


def matmul_nest(name: str, *, M: int, N: int, K: int) -> LoopNest:
    """Plain GEMM O[m,n] += A[m,k] B[k,n] — used by the TPU kernel mapper."""
    bounds = {"M": M, "N": N, "K": K}
    A = TensorRef("A", dims=("M", "K"))
    Bt = TensorRef("B", dims=("K", "N"))
    O = TensorRef("O", dims=("M", "N"), output=True)
    return LoopNest(
        name=name,
        bounds=bounds,
        tensors=(A, Bt, O),
        reduction_dims=frozenset({"K"}),
    )


def divisors(n: int) -> list[int]:
    """Sorted divisors of n (used throughout blocking search)."""
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return small + large[::-1]
