"""PyTorch + CUDA port of the BO kernel tuner (paper §III) for NVIDIA Hopper.

Mirrors the layout of the JAX reference package ``repro`` module for module,
so each counterpart is found under the same path. It imports torch, numpy
and scipy only, never JAX and nothing of ``repro``: modules without JAX in
the reference are carried here as copies. Entry points run on the card
unless the caller passes ``device="cpu"``; the hand-written CUDA kernels
under ``kernels/csrc`` are built with ``nvcc`` at first use.
"""
