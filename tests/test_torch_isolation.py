"""The port stands alone and refuses what it does not do yet.

* Importing every `repro_torch` module loads neither `jax` nor any module
  of the reference package `repro` (checked in a fresh interpreter).
* `run_mc`, `Model.init_params` and the serve launcher with no `device`
  raise where CUDA is absent instead of running on the CPU.
* Every argument, value, architecture or model option outside the ported
  slices raises `NotImplementedError` naming its ROADMAP item.
"""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.mc.engine import run_mc  # noqa: E402
from repro_torch.core.mc.problems import (problem_from_arrays,  # noqa: E402
                                          quadratic_mc_problem)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                 "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "repro"
             or m.startswith("repro."))
print(",".join(names), bad)
"""
# the RWKV6 slice's modules, which the walk above must reach
RWKV_MODULES = {"repro_torch.configs.rwkv6_7b", "repro_torch.models.rwkv",
                "repro_torch.kernels.wkv", "repro_torch.kernels.wkv.kernel",
                "repro_torch.kernels.wkv.ops", "repro_torch.kernels.wkv.ref"}


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    names, loaded = set(out[0].split(",")), out[1].strip()
    assert len(names) >= 40
    assert RWKV_MODULES <= names, RWKV_MODULES - names
    assert loaded == "[]", f"repro_torch pulled in: {loaded}"


def _problem(n=6, d=3):
    rs = np.random.default_rng(0)
    X = rs.standard_normal((n, d))
    y = rs.standard_normal(n)
    return quadratic_mc_problem(X, y, 0.5, np.zeros(d), device="cpu")


def test_run_mc_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quadratic_mc_problem(np.ones((2, 2)), np.ones(2), 0.5, np.zeros(2))


OUT_OF_SLICE = [
    ({"n_antennas": 2}, "P3"),
    ({"power_budget": 1.0}, "P3"),
    ({"batch_frac": 0.5}, "P6"),
    ({"seed_chunk": 1}, "P8"),
    ({"resume_dir": "ckpt"}, "P8"),
    ({"plan": "auto"}, "P9"),
    ({"memory_budget_bytes": 2**30}, "P9"),
    ({"shard_seeds": True}, "M8"),
    ({"rng_plan": "hoisted"}, "P9"),
    ({"rng_plan": "inscan"}, "P9"),
    ({"plan": "hoisted"}, "P9"),
]


@pytest.mark.parametrize("kwargs,item", OUT_OF_SLICE)
def test_out_of_slice_arguments_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cpu", **kwargs)


@pytest.mark.parametrize("algo", ["blind", "blind_ec"])
def test_unported_algorithms_raise(algo):
    with pytest.raises(NotImplementedError, match="ROADMAP P3"):
        run_mc(_problem(), [ChannelConfig()], algo, [0.01], 3, 2,
               device="cpu")


def test_mixed_algo_rows_and_node_counts_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP P5"):
        problem_from_arrays("logistic", {}, 4, 2, device="cpu")


# ----------------------------------------------------------- serving slice
from repro_torch.configs.registry import PENDING, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


def test_serving_entry_points_without_device_raise_where_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("olmo-1b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--new-tokens", "1", "--prompt-len", "2"])


def test_rwkv_entry_points_without_device_raise_where_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("rwkv6-7b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-7b", "--new-tokens", "1",
                    "--prompt-len", "2"])


@pytest.mark.parametrize("arch", sorted(PENDING))
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {PENDING[arch]}"):
        get_config(arch)


OUT_OF_SLICE_CONFIG = [
    ({"sliding_window": 16, "layer_pattern": "alt_local_global"}, "S2"),
    ({"attn_softcap": 50.0}, "S2"),
    ({"final_softcap": 30.0}, "S2"),
    ({"norm_style": "sandwich"}, "S2"),
    ({"embed_scale": True}, "S2"),
    ({"qk_norm": True}, "S2"),
    ({"opt_int8_cache": True}, "S3"),
    ({"opt_pad_heads": True}, "S3"),
    ({"n_experts": 4}, "S4"),
    ({"use_mla": True}, "S5"),
    ({"family": "hybrid"}, "S6"),
    ({"family": "encdec"}, "S7"),
    ({"n_patches": 8}, "S7"),
    ({"use_rope": False}, "S7"),
    ({"opt_flash_vjp": True}, "T2"),
]


@pytest.mark.parametrize("overrides,item", OUT_OF_SLICE_CONFIG)
def test_out_of_slice_config_raises(overrides, item):
    cfg = get_config("olmo-1b").reduced().with_(**overrides)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build_model(cfg)


def test_training_entry_points_raise():
    cfg = get_config("repro-100m").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP T1"):
        build_model(cfg).train_loss_per_example({}, {})
    with pytest.raises(NotImplementedError, match="ROADMAP T1"):
        transformer.chunked_xent({}, None, None, None, cfg)


# ------------------------------------------- node participation and ablations
from repro_torch.figures import run_ablations  # noqa: E402


@pytest.mark.parametrize("participation", [0.0, 1.5, -0.2, [1.0, 0.5]])
def test_participation_outside_the_unit_interval_raises(participation):
    with pytest.raises(ValueError, match="participation"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cpu", participation=participation)


@pytest.mark.parametrize("part", ["d", "f"])
def test_antenna_ablations_raise(part):
    with pytest.raises(NotImplementedError, match="ROADMAP P3"):
        run_ablations(device="cpu", parts=("a", part), n=6, steps=2,
                      seeds=1)
