"""Plain oracle: valid conv, NHWC x (FX, FY, C, K) -> NHWC, any stride.

The port of ``repro/kernels/conv2d/ref.py``: computed in fp32 and cast to
``x.dtype``.  The first filter axis walks H, the second W (HWIO, as
``jax.lax.conv_general_dilated`` reads it).  On the card cuDNN would run an
fp32 convolution in TF32; the oracle turns that off for its call.
"""

import torch
import torch.nn.functional as F


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(
            x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=stride
        )
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)
