"""Parameter trees between the JAX reference and the port, through numpy.

The reference's ``Model.init`` returns a nested dict of arrays with the
layer axis stacked in front (``repro/arch/transformer.py:148-183``); the
port keeps exactly that layout, so conversion is leaf by leaf.

bfloat16 crosses as its raw bits: a numpy bf16 leaf (``ml_dtypes``) is
viewed as ``uint16`` and reinterpreted as ``torch.bfloat16``, and back.
The port never imports ``ml_dtypes``; :func:`params_to_jax` takes the
numpy bf16 dtype from its caller.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    # a private copy: the caller's arrays may be read-only views of JAX
    # buffers, and the port's tensors must not alias them
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor, bf16_dtype):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.uint16).numpy()
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def _map(tree, f):
    if isinstance(tree, dict):
        return {k: _map(v, f) for k, v in tree.items()}
    return f(tree)


def params_from_jax(tree, device=None) -> dict:
    """Nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``)
    -> the port's nested dict of tensors on ``device``; bit-exact."""
    return _map(tree, lambda a: _leaf_to_torch(a, device))


def params_to_jax(params: dict, bf16_dtype=None) -> dict:
    """The inverse: tensors -> numpy arrays, bit-exact.  bf16 leaves come
    back as their ``uint16`` bits, or viewed as ``bf16_dtype`` when the
    caller passes one (e.g. ``jnp.bfloat16``)."""
    return _map(params, lambda t: _leaf_to_numpy(t, bf16_dtype))
