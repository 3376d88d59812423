"""The benchmark of the PyTorch port (``transfer_em_tpu_torch``): see
README.md.  Nothing here imports JAX or the JAX package."""
