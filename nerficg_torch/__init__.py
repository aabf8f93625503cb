"""nerficg_torch: the PyTorch + CUDA port of nerficg_tpu for NVIDIA Hopper.

The package mirrors ``nerficg_tpu``'s module paths. It imports ``torch`` and
never ``jax`` (nor ``nerficg_tpu``, whose imports pull in jax). Every Pallas
kernel on a ported path is replaced by a hand-written CUDA kernel under
``nerficg_torch/csrc/``, built at first use into ``build/`` (see
``nerficg_torch/ops/_kernels.py``); each kernel's plain PyTorch twin lives
beside its wrapper and runs for CPU tensors.
"""
