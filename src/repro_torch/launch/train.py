"""Training launcher: `python -m repro_torch.launch.train --arch
repro-100m --steps 200 --aggregator gbma` (port of
`repro.launch.train`). Runs on the CUDA card unless `--device cpu` is
given.

`--aggregator` accepts every algorithm of the MAC registry
(`core/mc/slots.ALGO_REGISTRY`): gbma / fdm / centralized take the fused
route; blind / blind_ec / momentum / nesterov / power_control the
channel-transport route (per-node gradients over the simulated MAC). The
blind family needs `--antennas`; `--power-budget` bounds blind_ec's
per-node slot energy; `--block-d` / `--transmit-dtype` set the
transport's tiling and bf16 transmit. Weights are random, from a torch
generator seeded 0 on the device (`Model.init_params`); the batches are
the reference launcher's (`train_batches`): `SyntheticTokens`, with
zero f32 patch embeddings before the tokens of a VLM (pixtral-12b: its
`--seq` counts the 1,024 patches, so it needs `--seq` 1,025 or more) and
zero f32 frames for the encoder-decoder (whisper-small: its encoder then
computes in f32).
"""
from __future__ import annotations

import argparse
import math
from typing import Iterator

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import transport
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.gbma import GBMAConfig
from repro_torch.core.mc.slots import ALGO_REGISTRY
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import SyntheticTokens, TokenDatasetConfig
from repro_torch.models.model import build_model
from repro_torch.optim.gd import get_optimizer
from repro_torch.training.loop import run_training
from repro_torch.training.train_step import (TrainConfig, build_train_step,
                                             resolve_route)


def train_batches(cfg: ModelConfig, batch: int, seq: int) -> Iterator[dict]:
    """The reference launcher's batches, as host arrays: `SyntheticTokens`
    of (batch, seq + 1) tokens at the reference's seed; a VLM's cut to
    `seq - n_patches + 1` after zero f32 patch embeddings (batch,
    n_patches, d_model); an encoder-decoder's zero f32 frames (batch,
    enc_seq, d_model). A VLM's `seq` counts its patches: at `seq <=
    n_patches` the reference's cut keeps too few tokens, none at
    pixtral-12b's default (ROADMAP §3 F16), so this raises, at the call."""
    if cfg.n_patches and seq <= cfg.n_patches:
        raise ValueError(
            f"--seq {seq} leaves no token after {cfg.arch_id}'s "
            f"{cfg.n_patches} patches: pass --seq {cfg.n_patches + 1} or "
            f"more")
    ds = SyntheticTokens(TokenDatasetConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))

    def make(tokens: np.ndarray) -> dict:
        out = {"tokens": tokens}
        if cfg.n_patches:
            out["patch_embed"] = np.zeros((batch, cfg.n_patches,
                                           cfg.d_model), np.float32)
            out["tokens"] = tokens[:, :seq - cfg.n_patches + 1]
        if cfg.family == "encdec":
            out["frames"] = np.zeros((batch, cfg.enc_seq, cfg.d_model),
                                     np.float32)
        return out

    return (make(tokens) for tokens in ds)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--aggregator", default="gbma",
                    choices=tuple(ALGO_REGISTRY))
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--noise-std", type=float, default=0.01)
    ap.add_argument("--energy-eps", type=float, default=None,
                    help="E_N = nodes^(eps-2); default E_N = 1")
    ap.add_argument("--fading", default="rayleigh")
    ap.add_argument("--optimizer", default="momentum")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--antennas", type=int, default=None,
                    help="edge antenna count M (required for blind/"
                         "blind_ec; MRC path for precoded aggregators)")
    ap.add_argument("--power-budget", type=float, default=None,
                    help="blind_ec per-node per-slot squared-norm budget")
    ap.add_argument("--gamma", type=float, default=0.9,
                    help="receiver momentum of momentum/nesterov "
                         "aggregators")
    ap.add_argument("--block-d", type=int, default=None,
                    help="transport column-tile width (default: one block "
                         "per parameter leaf)")
    ap.add_argument("--transmit-dtype", default=None,
                    choices=(None, "bfloat16"),
                    help="cast transmitted gradient blocks (transport "
                         "route); accumulation stays f32")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    batches = train_batches(cfg, args.batch, args.seq)
    model = build_model(cfg)
    params = model.init_params(device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.arch_id} params={n_params/1e6:.1f}M "
          f"aggregator={args.aggregator} nodes={args.nodes}")

    energy = (args.nodes ** (args.energy_eps - 2.0)
              if args.energy_eps is not None else 1.0)
    channel = ChannelConfig(fading=args.fading, noise_std=args.noise_std,
                            energy=energy)
    route = resolve_route(TrainConfig(aggregator=args.aggregator))
    tcfg = TrainConfig(
        aggregator=args.aggregator,
        gbma=GBMAConfig(n_nodes=args.nodes, channel=channel),
        transport=transport.TransportConfig(
            n_nodes=args.nodes, channel=channel, n_antennas=args.antennas,
            power_budget=(args.power_budget if args.power_budget is not None
                          else math.inf),
            gamma=args.gamma, stepsize=args.lr, block_d=args.block_d,
            transmit_dtype=args.transmit_dtype)
        if route == "transport" else None)
    opt = get_optimizer(args.optimizer, args.lr)
    step = build_train_step(model, tcfg, opt)

    params, opt_state, hist = run_training(
        step, params, step.init_state(params), batches, args.steps,
        log_every=max(args.steps // 20, 1))
    if args.checkpoint:
        ckpt.save(args.checkpoint, params)
        print(f"saved checkpoint to {args.checkpoint}")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
