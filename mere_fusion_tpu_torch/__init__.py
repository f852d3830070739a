"""PyTorch/CUDA port of mere-fusion-tpu.

A second package beside the JAX one: the same serving stack for one live
MuseTalk session (TTS → whisper features → UNet + VAE → blended frames →
paced tracks → aiohttp session server), written in PyTorch for an NVIDIA
Hopper GPU. The JAX package's Pallas kernels on this path become kernels
written by hand for sm_90a (``csrc/``). Nothing here imports jax, flax or
the JAX package; its own tests hold each module against its JAX twin.
"""
