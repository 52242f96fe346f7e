"""PyTorch + CUDA port of ilqgames_tpu for NVIDIA Hopper GPUs.

The JAX package `ilqgames_tpu` stays the reference: module paths and
names mirror it, and the tests hold each ported function against its JAX
counterpart. This package imports torch and never jax.
"""
