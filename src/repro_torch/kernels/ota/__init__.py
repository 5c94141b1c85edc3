"""OTA edge aggregation: CUDA kernel, plain version and wrapper."""
