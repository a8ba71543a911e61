"""PyTorch/CUDA port of vqwild_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module; imports torch, numpy
and the standard library only. Kernels are hand-written CUDA C++ under
``csrc/``, built with nvcc at first use (ops/_build.py).
"""
