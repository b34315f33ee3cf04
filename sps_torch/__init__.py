"""sps_torch: the PyTorch/CUDA port of sps_tpu (Stable Points Segmentation).

Mirrors sps_tpu's module names; imports nothing of sps_tpu or JAX. Entry
points run on the card unless the caller passes device="cpu".
"""
