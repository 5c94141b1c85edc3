"""The analytic model (`repro_torch.launch.analytic`,
`launch.analysis.RooflineTerms`, `models.model.InputShape` / `SHAPES` /
`Model.params_shape`) against the reference's, on the CPU.

`param_counts` (total and active a token) and `model_flops` (6·N·D a
training step, 2·N·D an inference pass, the attention term with windows,
MLA's head widths and hymba's SSM branch) are pure arithmetic on the
config and the parameter shapes: they equal the reference's exactly on
every registered config at every `SHAPES` entry, on 1 and 4 chips.
`params_shape` walks the initializers on the meta device: every leaf is
a meta tensor (nothing allocated, deepseek-v3's 671 B parameters in a
few seconds), with the reference's `params_shape` shapes and dtypes,
leaf by leaf in JAX's order. `RooflineTerms` is the reference's with the
H100's rates (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s NVLink a
direction) in place of its TPU v5e ones.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import _MODULES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import analysis as jax_analysis  # noqa: E402
from repro.launch import analytic as jax_analytic  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import analysis, analytic  # noqa: E402
from repro_torch.models import model as torch_model  # noqa: E402

ARCHS = sorted(_MODULES)


@functools.lru_cache(maxsize=None)
def _reference_counts(arch: str) -> tuple:
    return jax_analytic.param_counts(
        jax_model.build_model(jax_get_config(arch)))


@functools.lru_cache(maxsize=None)
def _port_counts(arch: str) -> tuple:
    return analytic.param_counts(
        torch_model.build_model(get_config(arch)))


def test_shapes_are_the_references():
    assert list(torch_model.SHAPES) == list(jax_model.SHAPES)
    for name, shape in torch_model.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_model.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_is_the_references(arch):
    ours = tree_leaves(torch_model.build_model(get_config(arch))
                       .params_shape())
    ref = jax.tree_util.tree_leaves(
        jax_model.build_model(jax_get_config(arch)).params_shape())
    assert all(x.is_meta for x in ours)
    assert [tuple(x.shape) for x in ours] == [tuple(x.shape) for x in ref]
    assert [str(x.dtype).removeprefix("torch.") for x in ours] == \
        [str(x.dtype) for x in ref]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_references(arch):
    assert _port_counts(arch) == _reference_counts(arch)
    total, active = _port_counts(arch)
    cfg = get_config(arch)
    assert (active < total) == bool(cfg.n_experts)


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_references(arch, chips, monkeypatch):
    """Every SHAPES entry; each package's `param_counts` (held above)
    from its cache, so the walk runs once an architecture."""
    monkeypatch.setattr(jax_analytic, "param_counts",
                        lambda m: _reference_counts(m.cfg.arch_id))
    monkeypatch.setattr(analytic, "param_counts",
                        lambda m: _port_counts(m.cfg.arch_id))
    jm = jax_model.build_model(jax_get_config(arch))
    m = torch_model.build_model(get_config(arch))
    for name, shape in torch_model.SHAPES.items():
        ours = analytic.model_flops(m, shape, chips)
        ref = jax_analytic.model_flops(jm, jax_model.SHAPES[name], chips)
        assert ours == ref, (arch, name, chips)
        assert ours > 0


def test_attention_flops_on_reduced_windows_and_mla():
    """The attention term alone, on reduced configs (windows shorter than
    the sequence, MLA's head widths, hymba's SSM branch), causal and
    not, at a decode and a prefill length."""
    for arch in ("gemma2-9b", "deepseek-v3-671b", "hymba-1.5b", "rwkv6-7b",
                 "llama4-maverick-400b-a17b"):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        for sq, skv, causal in ((1, 40, False), (40, 40, True),
                                (24, 24, False)):
            assert analytic._attention_flops(cfg, 3, sq, skv, causal) == \
                jax_analytic._attention_flops(jcfg, 3, sq, skv, causal)


def test_roofline_terms_use_the_cards_rates():
    kw = dict(hlo_flops=3.0e14, hlo_bytes=2.0e12, coll_bytes=9.0e10,
              model_flops=2.5e14, chips=4)
    ours, ref = analysis.RooflineTerms(**kw), jax_analysis.RooflineTerms(**kw)
    assert ours.as_dict().keys() == ref.as_dict().keys()
    assert ours.compute_s == 3.0e14 / 989e12
    assert ours.memory_s == 2.0e12 / 3.35e12
    assert ours.collective_s == 9.0e10 / 450e9
    assert ours.useful_ratio == ref.useful_ratio
    scale = {"compute_s": jax_analysis.PEAK_FLOPS / analysis.PEAK_FLOPS,
             "memory_s": jax_analysis.HBM_BW / analysis.HBM_BW,
             "collective_s": jax_analysis.ICI_BW / analysis.NVLINK_BW}
    for key, factor in scale.items():
        np.testing.assert_allclose(getattr(ours, key),
                                   getattr(ref, key) * factor, rtol=1e-12)
    assert ours.dominant == "memory"
    assert analysis.RooflineTerms(0.0, 0.0, 0.0, 0.0, 1).useful_ratio == 0.0
