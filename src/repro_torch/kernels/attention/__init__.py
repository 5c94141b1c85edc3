"""Flash attention: CUDA kernel, plain version and wrapper."""
