"""The Monte Carlo engine (port of `repro.core.mc`): problems, sampling,
slots, exec and engine. Import `run_mc` from
`repro_torch.core.mc.engine`."""
