"""CLIMBER++ on PyTorch and CUDA (NVIDIA Hopper).

A module-for-module port of the JAX package ``repro``: the same index
build, planners and refine, with the Pallas kernels replaced by CUDA C++
kernels written for ``sm_90a`` (``repro_torch/csrc``).  Tensors on the card
go through the kernels; tensors on the CPU go through each kernel's plain
PyTorch version.

The OD/WD one-hot matmuls and the pivot distances need full fp32, so the
port turns TF32 off for matmuls and cuDNN when it is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
