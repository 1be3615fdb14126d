"""Host copies of tensors that ``np.savez`` can store, and back; port of
``repro/ckpt/checkpoint.py``'s ``_to_savable``/``_from_savable`` (the rest
of the module is ROADMAP A11).

numpy has no bfloat16, so a bf16 tensor is stored as its uint16 bits and
the manifest names its dtype as the reference spells it (``"bfloat16"``,
:func:`dtype_name`); loading views the bits back.  No ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's spelling of a dtype,
    the one the manifests use."""
    return str(dtype).removeprefix("torch.")


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a real copy on every device, through a
    blocking device-to-host transfer), bf16 as its uint16 bits."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_savable(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """The CPU tensor :func:`_to_savable` stored, ``dtype_str`` its
    manifest dtype."""
    arr = np.ascontiguousarray(arr)
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
