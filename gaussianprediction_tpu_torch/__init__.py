"""PyTorch/CUDA port of gaussianprediction_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here keeps
the layout and names of its counterpart there. The port imports torch and
numpy only: never jax, flax or anything of gaussianprediction_tpu.
"""
