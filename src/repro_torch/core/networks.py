"""Paper benchmark networks (§6.3): 4 CNNs, 3 LSTMs, 2 MLPs as loop nests.

CNNs at batch 16, MLPs at batch 128, matching the paper.  LSTM-M/L are the
Google seq2seq models with embedding sizes 500/1000; a cell step computes the
4-gate matmul [x;h](2E) x (2E,4E).  RHN (Recurrent Highway Network) uses the
published depth-10 cell with hidden 830 ("Variant A" on PTB).  MLPs follow
PRIME's benchmark suite.

Dims follow paper Algorithm 1: X/Y are OUTPUT extents; FC layers use only
(B, C, K) with the rest 1.

The port's copy of the reference's ``core/networks.py``: the port's conv2d
kernel runs the CNN tables' CONV layers, its optimizer and DSE the rest.
"""

from __future__ import annotations

from repro_torch.core.loopnest import LoopNest, conv_nest, depthwise_nest, fc_nest


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


def alexnet_conv3(batch: int = 16) -> LoopNest:
    return alexnet(batch)[2]


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


def googlenet_4c3r(batch: int = 16) -> LoopNest:
    return next(n for n in googlenet(batch) if n.name == "4c3r")


def mobilenet(batch: int = 16) -> list[LoopNest]:
    """MobileNet v1 (1.0, 224): depthwise-separable stacks."""
    B = batch
    nets = [conv_nest("conv1", B=B, K=32, C=3, X=112, Y=112, FX=3, FY=3, stride=2)]
    # (C, X_out, stride) for each dw/pw pair
    cfg = [
        (32, 112, 1, 64), (64, 56, 2, 128), (128, 56, 1, 128),
        (128, 28, 2, 256), (256, 28, 1, 256), (256, 14, 2, 512),
        (512, 14, 1, 512), (512, 14, 1, 512), (512, 14, 1, 512),
        (512, 14, 1, 512), (512, 14, 1, 512), (512, 7, 2, 1024),
        (1024, 7, 1, 1024),
    ]
    for i, (c, x, s, k) in enumerate(cfg):
        nets.append(depthwise_nest(f"dw{i+2}", B=B, C=c, X=x, Y=x, FX=3, FY=3, stride=s))
        nets.append(conv_nest(f"pw{i+2}", B=B, K=k, C=c, X=x, Y=x, FX=1, FY=1))
    nets.append(fc_nest("fc", B=B, C=1024, K=1000))
    return nets


def lstm(name: str, embed: int, batch: int = 1, steps: int = 1) -> list[LoopNest]:
    """One LSTM cell step: [x;h] (2E) x (2E, 4E) gate matmul per step."""
    return [
        fc_nest(f"{name}_gates", B=batch * steps, C=2 * embed, K=4 * embed)
    ]


def lstm_m(batch: int = 1) -> list[LoopNest]:
    return lstm("lstm_m", 500, batch)


def lstm_l(batch: int = 1) -> list[LoopNest]:
    return lstm("lstm_l", 1000, batch)


def rhn(batch: int = 1) -> list[LoopNest]:
    """Recurrent Highway Network, depth-10, hidden 830 (Zilly et al.)."""
    H = 830
    layers = [fc_nest("rhn_in", B=batch, C=2 * H, K=2 * H)]
    layers += [fc_nest(f"rhn_d{i}", B=batch, C=H, K=2 * H) for i in range(9)]
    return layers


def mlp_m(batch: int = 128) -> list[LoopNest]:
    """PRIME MLP-M: 784-500-250-10."""
    B = batch
    return [
        fc_nest("fc1", B=B, C=784, K=500),
        fc_nest("fc2", B=B, C=500, K=250),
        fc_nest("fc3", B=B, C=250, K=10),
    ]


def mlp_l(batch: int = 128) -> list[LoopNest]:
    """PRIME MLP-L: 784-1500-1000-500-10."""
    B = batch
    return [
        fc_nest("fc1", B=B, C=784, K=1500),
        fc_nest("fc2", B=B, C=1500, K=1000),
        fc_nest("fc3", B=B, C=1000, K=500),
        fc_nest("fc4", B=B, C=500, K=10),
    ]


# ------------------------------------------------------------- DSE suite ----
# Scaled sweep workloads for the resource-allocation DSE (core/dse.py, paper
# Fig 10-12): one representative per network class, with bounds chosen so a
# full (hierarchy x layer x tiling x order) sweep finishes in benchmark
# wall-clock while keeping the paper's shape signatures (deep conv stacks
# with repeated layer shapes; wide single-matmul LSTM gates; tapering MLP).


def dse_cnn(batch: int = 4) -> list[LoopNest]:
    """Compact conv stack in the AlexNet/VGG mold (repeated mid-layers)."""
    B = batch
    return [
        conv_nest("c1", B=B, K=32, C=8, X=28, Y=28, FX=3, FY=3),
        conv_nest("c2", B=B, K=64, C=32, X=14, Y=14, FX=3, FY=3),
        conv_nest("c2b", B=B, K=64, C=32, X=14, Y=14, FX=3, FY=3),
        conv_nest("c3", B=B, K=64, C=64, X=7, Y=7, FX=3, FY=3),
        fc_nest("fc", B=B, C=3136, K=256),
    ]


def dse_lstm(batch: int = 4) -> list[LoopNest]:
    """LSTM-M-shaped gate matmul (paper: Google seq2seq embed 500) at a
    sweep-tractable embedding."""
    return lstm("dse_lstm", embed=256, batch=batch)


def dse_mlp(batch: int = 32) -> list[LoopNest]:
    """PRIME-style tapering MLP at sweep-tractable widths."""
    B = batch
    return [
        fc_nest("fc1", B=B, C=784, K=512),
        fc_nest("fc2", B=B, C=512, K=256),
        fc_nest("fc3", B=B, C=256, K=16),
    ]


DSE_SUITE = {
    "cnn": dse_cnn,
    "lstm": dse_lstm,
    "mlp": dse_mlp,
}


PAPER_BENCHMARKS = {
    "alexnet": alexnet,
    "vgg16": vgg16,
    "googlenet": googlenet,
    "mobilenet": mobilenet,
    "lstm_m": lstm_m,
    "lstm_l": lstm_l,
    "rhn": rhn,
    "mlp_m": mlp_m,
    "mlp_l": mlp_l,
}
