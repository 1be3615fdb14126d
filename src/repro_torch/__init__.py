"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

It mirrors ``repro``'s module tree (``repro_torch/arch/layers.py`` is the
counterpart of ``repro/arch/layers.py`` and so on), imports ``torch`` and
never ``jax``, and imports nothing of ``repro``: where it needs a
JAX-free module of the reference (the configs) it keeps its own copy.
Every Pallas kernel on the ported path is a hand-written CUDA kernel under
``kernels/csrc``; each kernel wrapper runs the kernel's plain PyTorch
version only for tensors that lie on the CPU.
"""
