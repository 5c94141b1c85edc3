"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
dispatch wrapper (`kernel.py` / `ref.py` / `ops.py`, as in `repro.kernels`)."""
