"""The port stands alone and refuses what it does not do yet.

* Importing every `repro_torch` module loads neither `jax` nor any module
  of the reference package `repro` (checked in a fresh interpreter).
* `run_mc` with no `device` raises where CUDA is absent instead of
  running on the CPU.
* Every argument or value outside the ported slice raises
  `NotImplementedError` naming its ROADMAP item.
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
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    n_modules, loaded = int(out[0]), out[1].strip()
    assert n_modules >= 15
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
    ({"invert_channel": True}, "P4"),
    ({"power_budget": 1.0}, "P4"),
    ({"batch_frac": 0.5}, "P6"),
    ({"participation": 0.8}, "P7"),
    ({"seed_chunk": 1}, "P8"),
    ({"resume_dir": "ckpt"}, "P8"),
    ({"plan": "auto"}, "P9"),
    ({"memory_budget_bytes": 2**30}, "P9"),
    ({"shard_seeds": True}, "M8"),
    ({"h_min": 0.3}, "P4"),
    ({"rng_plan": "hoisted"}, "P9"),
    ({"rng_plan": "inscan"}, "P9"),
    ({"plan": "hoisted"}, "P9"),
]


@pytest.mark.parametrize("kwargs,item", OUT_OF_SLICE)
def test_out_of_slice_arguments_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cpu", **kwargs)


@pytest.mark.parametrize("algo", ["fdm", "power_control", "blind",
                                  "blind_ec"])
def test_unported_algorithms_raise(algo):
    with pytest.raises(NotImplementedError, match="ROADMAP P4"):
        run_mc(_problem(), [ChannelConfig()], algo, [0.01], 3, 2,
               device="cpu")


def test_mixed_algo_rows_and_node_counts_raise():
    chs = [ChannelConfig(), ChannelConfig()]
    with pytest.raises(NotImplementedError, match="ROADMAP P2"):
        run_mc(_problem(), chs, ("gbma", "centralized"), [0.01, 0.01], 3,
               2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP P1"):
        run_mc([_problem(6), _problem(9)], chs, "gbma", [0.01, 0.01], 3, 2,
               device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP P5"):
        problem_from_arrays("logistic", {}, 4, 2, device="cpu")
