"""Serving launcher: `python -m repro_torch.launch.serve --arch olmo-1b
--full` — batched prefill + decode with the port's engine (port of
`repro.launch.serve`).

Runs on the CUDA card unless `--device cpu` is given. Weights are random,
drawn from a torch generator seeded 0 on the device
(`Model.init_params`); the prompt is
uniform random token ids from a generator seeded 1, which then draws
whisper's f32 frame embeddings (B, enc_seq, D) and the VLM's f32 patch
embeddings (B, n_patches, D) from a standard normal, as the reference
draws them. Prints the reference's summary line.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init_params(device=device)
    eng = Engine(model, params, ServeConfig(max_new_tokens=args.new_tokens,
                                            temperature=args.temperature))
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    if cfg.n_patches:
        batch["patch_embed"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model), generator=gen,
            device=device)
    if model.kind == "encdec":
        batch["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=device)
    t0 = time.time()
    out = eng.generate(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tput = args.batch * args.new_tokens / dt
    print(f"arch={cfg.arch_id} generated {tuple(out.shape)} in {dt:.1f}s "
          f"({tput:.1f} tok/s)")


if __name__ == "__main__":
    main()
