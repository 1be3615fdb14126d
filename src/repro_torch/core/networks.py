"""The paper's CNN benchmarks (§6.3) as loop nests, at its batch of 16.

The port's copy of the CNN tables of the reference's ``core/networks.py``:
AlexNet, VGG-16 and GoogLeNet, whose CONV layers the port's conv2d kernel
runs.  Dims follow paper Algorithm 1: X/Y are OUTPUT extents; FC layers use
only (B, C, K) with the rest 1.  The LSTM, MLP, MobileNet and DSE tables
wait for the port's optimizer.
"""

from __future__ import annotations

from repro_torch.core.loopnest import LoopNest, conv_nest, fc_nest


def alexnet(batch: int = 16) -> list[LoopNest]:
    B = batch
    return [
        conv_nest("conv1", B=B, K=96, C=3, X=55, Y=55, FX=11, FY=11, stride=4),
        conv_nest("conv2", B=B, K=256, C=96, X=27, Y=27, FX=5, FY=5),
        conv_nest("conv3", B=B, K=384, C=256, X=13, Y=13, FX=3, FY=3),
        conv_nest("conv4", B=B, K=384, C=384, X=13, Y=13, FX=3, FY=3),
        conv_nest("conv5", B=B, K=256, C=384, X=13, Y=13, FX=3, FY=3),
        fc_nest("fc6", B=B, C=9216, K=4096),
        fc_nest("fc7", B=B, C=4096, K=4096),
        fc_nest("fc8", B=B, C=4096, K=1000),
    ]


def vgg16(batch: int = 16) -> list[LoopNest]:
    B = batch
    cfg = [  # (K, C, X=Y)
        (64, 3, 224), (64, 64, 224),
        (128, 64, 112), (128, 128, 112),
        (256, 128, 56), (256, 256, 56), (256, 256, 56),
        (512, 256, 28), (512, 512, 28), (512, 512, 28),
        (512, 512, 14), (512, 512, 14), (512, 512, 14),
    ]
    nets = [
        conv_nest(f"conv{i+1}", B=B, K=k, C=c, X=x, Y=x, FX=3, FY=3)
        for i, (k, c, x) in enumerate(cfg)
    ]
    nets += [
        fc_nest("fc14", B=B, C=25088, K=4096),
        fc_nest("fc15", B=B, C=4096, K=4096),
        fc_nest("fc16", B=B, C=4096, K=1000),
    ]
    return nets


def googlenet(batch: int = 16) -> list[LoopNest]:
    """Representative GoogLeNet layers incl. the paper's 4C3R example
    (inception-4c 3x3-reduce: 14x14x512 -> 128 via 1x1)."""
    B = batch
    return [
        conv_nest("conv1", B=B, K=64, C=3, X=112, Y=112, FX=7, FY=7, stride=2),
        conv_nest("conv2_red", B=B, K=64, C=64, X=56, Y=56, FX=1, FY=1),
        conv_nest("conv2", B=B, K=192, C=64, X=56, Y=56, FX=3, FY=3),
        conv_nest("3a_1x1", B=B, K=64, C=192, X=28, Y=28, FX=1, FY=1),
        conv_nest("3a_3x3", B=B, K=128, C=96, X=28, Y=28, FX=3, FY=3),
        conv_nest("4c_1x1", B=B, K=128, C=512, X=14, Y=14, FX=1, FY=1),
        conv_nest("4c3r", B=B, K=128, C=512, X=14, Y=14, FX=1, FY=1),
        conv_nest("4c_3x3", B=B, K=256, C=128, X=14, Y=14, FX=3, FY=3),
        conv_nest("5b_3x3", B=B, K=384, C=192, X=7, Y=7, FX=3, FY=3),
        fc_nest("fc", B=B, C=1024, K=1000),
    ]
