"""PyTorch/CUDA port of msclip_tpu for one NVIDIA H100 (Hopper).

Imports torch, never jax, and nothing of msclip_tpu."""
