"""Mixture-of-Experts layer: llama4-style top-1 and deepseek-v3-style
shared + routed top-8, with GShard-style grouped capacity dispatch (port of
`repro.models.moe`).

Tokens are viewed as groups of (example, sequence chunk): up to
`GROUP_SIZE` = 256 positions of one example, halved until the chunk
divides the sequence. Within a group every expert has `_capacity` slots.
Routing runs in f32 (`x.float() @ router`), with softmax or sigmoid
scoring; deepseek-v3's `router_bias` is added to the scores for the
choice only, and the gate is read from the scores themselves. The top-k
choice is k rounds of argmax: a token's slot in its expert is the
cumsum of the round's one-hot over the group, minus itself, plus the
slots the earlier rounds used, so earlier tokens of the group win the
capacity and later ones are dropped (their gate is 0). The chosen expert
is masked with `- onehot * 1e9` before the next round; gates are
renormalized over the chosen experts when top_k > 1. The Switch aux loss
is E · mean_g Σ_e f_e · p_e.

The dispatch, the experts and the combine are the reference's dense
one-hot products, in plain PyTorch (the reference computes them outside
any Pallas kernel): `expert_in = dispatch · x` per group, each expert's
GLU over its (groups × slots) rows as one batched product, `out =
combine · expert_out`. Every expert's weights are read for every call,
decode steps included. The combine weights are f32, or bf16 under
`opt_bf16_dispatch` (each (token, expert, slot) cell is written at most
once over the rounds, so they lose no sum). `opt_shardmap_moe` changes
nothing on one card: without a mesh the reference's `_a2a_reshard`
returns its input unchanged.

Expert weights are drawn one expert at a time (`_expert_init`): a
maverick expert leaf is (128, 5120, 8192), 5.37 G values, a 21.5 GB
draw in f32 at once.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation, dense_init, dtype_of

GROUP_SIZE = 256  # tokens per routing group, as the reference's


def _expert_init(gen: torch.Generator, fan_in: int, shape,
                 dtype: torch.dtype) -> torch.Tensor:
    """`dense_init` of a stacked expert leaf, drawn one (layer, expert)
    matrix at a time into the leaf, so the f32 draw is one expert's."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    if out.is_meta:  # `Model.params_shape`: a shape, nothing to draw
        return out
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        out[idx] = dense_init(gen, fan_in, shape[-2:], dtype)
    return out


def moe_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    dt = dtype_of(cfg)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    p = {
        "router": dense_init(gen, d, (*lead, d, e), torch.float32),
        "experts_wi": _expert_init(gen, d, (*lead, e, d, f), dt),
        "experts_wg": _expert_init(gen, d, (*lead, e, d, f), dt),
        "experts_wo": _expert_init(gen, f, (*lead, e, f, d), dt),
    }
    if cfg.router_scoring == "sigmoid":
        p["router_bias"] = torch.zeros((*lead, e), dtype=torch.float32,
                                       device=gen.device)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = dense_init(gen, d, (*lead, d, fs), dt)
        p["shared_wg"] = dense_init(gen, d, (*lead, d, fs), dt)
        p["shared_wo"] = dense_init(gen, fs, (*lead, fs, d), dt)
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(min(tokens_per_group, max(c, 4)), 1)


def group_size(s: int) -> int:
    """Tokens a group: min(GROUP_SIZE, s), halved until it divides s."""
    tg = min(GROUP_SIZE, s)
    while s % tg:
        tg //= 2
    return tg


def route(xg: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    """The routing of grouped tokens xg (G, Tg, D): (dispatch (G, Tg, E,
    C) bool, combine (G, Tg, E, C) f32 or bf16 under `opt_bf16_dispatch`,
    aux f32 scalar), C = `_capacity(Tg)`."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(tg, cfg)
    logits = xg.float() @ p["router"]
    if cfg.router_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        sel_scores = scores + p["router_bias"]
    else:
        scores = torch.softmax(logits, dim=-1)
        sel_scores = scores

    comb_dt = torch.bfloat16 if cfg.opt_bf16_dispatch else torch.float32
    dev = xg.device
    dispatch = torch.zeros((g, tg, e, cap), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, tg, e, cap), dtype=comb_dt, device=dev)
    counts = torch.zeros((g, e), dtype=torch.int32, device=dev)
    remaining = sel_scores
    gate_sum = torch.zeros((g, tg), dtype=torch.float32, device=dev)
    frac_routed = torch.zeros((g, e), dtype=torch.float32, device=dev)
    for _ in range(k):
        eid = torch.argmax(remaining, dim=-1)  # (G, Tg), first of ties
        onehot = F.one_hot(eid, e).float()  # (G, Tg, E)
        frac_routed += onehot.mean(dim=1)
        # each token's position within its expert's slots this round
        pos_in_e = torch.cumsum(onehot, dim=1) - onehot + counts[:, None]
        slot = (pos_in_e * onehot).sum(dim=-1).to(torch.int32)
        keep = slot < cap
        gate = torch.gather(scores, -1, eid[..., None])[..., 0]
        gate = torch.where(keep, gate, 0.0)
        slot_oh = F.one_hot(torch.where(keep, slot, cap).long(),
                            cap + 1).to(comb_dt)[..., :cap]  # (G, Tg, C)
        d_k = onehot.to(comb_dt)[..., None] * slot_oh[:, :, None, :]
        dispatch |= d_k.bool()
        combine += gate.to(comb_dt)[..., None, None] * d_k
        gate_sum += gate
        counts += onehot.sum(dim=1).to(torch.int32)
        remaining = remaining - onehot * 1e9  # mask the chosen expert
    if k > 1:  # renormalize the combined gates over the chosen experts
        denom = torch.clamp_min(gate_sum, 1e-9)[..., None, None]
        combine = (combine / denom.to(comb_dt)).to(comb_dt)

    mean_prob = scores.mean(dim=1)  # (G, E)
    aux = e * torch.mean(torch.sum(frac_routed / k * mean_prob, dim=-1))
    return dispatch, combine, aux.float()


def _glu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
         wo: torch.Tensor, act: str) -> torch.Tensor:
    """act(x wg) * (x wi), then wo; batched over a leading expert axis
    when the weights have one."""
    return (activation(x @ wg, act) * (x @ wi)) @ wo


def moe_apply(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    """x (B, S, D) -> (out (B, S, D), aux f32 scalar)."""
    b, s, d = x.shape
    tg = group_size(s)
    g = b * s // tg
    xg = x.reshape(g, tg, d)  # (example, chunk) groups in order
    dispatch, combine, aux = route(xg, p, cfg)
    e, cap = dispatch.shape[2], dispatch.shape[3]

    # dispatch -> expert compute -> combine (the reference's einsums:
    # gtec,gtd->gecd; gecd,edf->gecf; gecf,efd->gecd; gtec,gecd->gtd)
    disp = dispatch.to(x.dtype).reshape(g, tg, e * cap)
    expert_in = disp.transpose(1, 2) @ xg  # (G, E·C, D)
    xe = expert_in.reshape(g, e, cap, d).transpose(0, 1).reshape(
        e, g * cap, d)  # each expert's (groups × slots) rows
    ye = _glu(xe, p["experts_wi"], p["experts_wg"], p["experts_wo"],
              cfg.act)  # (E, G·C, D)
    expert_out = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(
        g, e * cap, d)
    out = combine.to(x.dtype).reshape(g, tg, e * cap) @ expert_out

    if cfg.n_shared_experts:  # deepseek-v3
        out = out + _glu(xg, p["shared_wi"], p["shared_wg"],
                         p["shared_wo"], cfg.act)
    return out.reshape(b, s, d), aux
