"""RWKV6 WKV recurrence: CUDA kernel, plain version and wrapper."""
