"""The port stands alone and refuses what it does not do yet.

* Importing every `repro_torch` module loads neither `jax` nor any module
  of the reference package `repro` (checked in a fresh interpreter), and
  no import statement of the port's sources or `chip_smoke.py` names
  them.
* `run_mc`, `Model.init_params` and the serve launcher with no `device`
  raise where CUDA is absent instead of running on the CPU.
* Every argument or value outside the ported slices raises
  `NotImplementedError` naming its ROADMAP item. Every architecture of
  the reference resolves (`PENDING` is empty since S4 and S5), and the
  MoE, MLA and MTP options build and prefill.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.mc.engine import run_mc  # noqa: E402
from repro_torch.core.mc.plan import ExecPlan  # noqa: E402
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
# the RWKV6 slice's modules and the sweep server's, which the walk above
# must reach
RWKV_MODULES = {"repro_torch.configs.rwkv6_7b", "repro_torch.models.rwkv",
                "repro_torch.kernels.wkv", "repro_torch.kernels.wkv.kernel",
                "repro_torch.kernels.wkv.ops", "repro_torch.kernels.wkv.ref"}
SERVER_MODULES = {"repro_torch.serving.mc_server",
                  "repro_torch.launch.serve_mc",
                  "repro_torch.core.mc.costmodel"}
# the channel-transport substrate (M7)
TRANSPORT_MODULES = {"repro_torch.core.transport", "repro_torch.core.gbma",
                     "repro_torch.core.baselines",
                     "repro_torch.core.waveform", "repro_torch.core.tree"}
# the training stack (T1-T3)
TRAINING_MODULES = {"repro_torch.optim.gd", "repro_torch.data.synthetic",
                    "repro_torch.models.flash_vjp",
                    "repro_torch.models.transformer",
                    "repro_torch.models.model",
                    "repro_torch.training.train_step",
                    "repro_torch.training.loop", "repro_torch.launch.train"}

# training olmo-1b in bf16 (T4) and RWKV6 (T5): the attention kernel with
# its log-sum-exp, the differentiable WKV and the models' training forwards
MODEL_TRAINING_MODULES = {"repro_torch.kernels.attention.kernel",
                          "repro_torch.kernels.attention.ops",
                          "repro_torch.kernels.wkv.kernel",
                          "repro_torch.kernels.wkv.ops",
                          "repro_torch.kernels.wkv.ref",
                          "repro_torch.models.attention",
                          "repro_torch.models.rwkv"}
# the window, softcap and qk-norm families (S2) and rbg keys (T6)
S2_MODULES = {"repro_torch.configs.gemma2_9b", "repro_torch.configs.gemma_7b",
              "repro_torch.configs.minitron_4b", "repro_torch.core.rng",
              "repro_torch.models.transformer"}
# MoE (S4) and MLA (S5)
S4_S5_MODULES = {"repro_torch.configs.llama4_maverick_400b_a17b",
                 "repro_torch.configs.deepseek_v3_671b",
                 "repro_torch.models.moe", "repro_torch.models.mla",
                 "repro_torch.models.transformer",
                 "repro_torch.models.model"}
# the int8 cache (S3), hymba (S6), whisper and pixtral (S7)
S3_S7_MODULES = {"repro_torch.configs.hymba_1p5b",
                 "repro_torch.configs.whisper_small",
                 "repro_torch.configs.pixtral_12b", "repro_torch.models.ssm",
                 "repro_torch.models.encdec", "repro_torch.models.attention",
                 "repro_torch.serving.engine", "repro_torch.launch.serve"}
# the analytic model and the roofline terms
ANALYSIS_MODULES = {"repro_torch.launch.analytic",
                    "repro_torch.launch.analysis"}
# the mesh path of training (M12a): the rules, the layout, the
# collectives, the meshes and the dense decoder over a mesh
MESH_MODULES = {"repro_torch.sharding", "repro_torch.sharding.specs",
                "repro_torch.sharding.placement", "repro_torch.sharding.comm",
                "repro_torch.launch.mesh", "repro_torch.models.meshed"}
# serving over a mesh (M12b): the model's and the engine's mesh dispatch,
# the cache placement and the mesh prefill and decode
MESH_SERVE_MODULES = {"repro_torch.models.model",
                      "repro_torch.serving.engine",
                      "repro_torch.models.attention",
                      "repro_torch.models.meshed",
                      "repro_torch.sharding.placement",
                      "repro_torch.sharding.specs",
                      "repro_torch.sharding.comm"}


def _imported_roots(path: pathlib.Path) -> set:
    """The top-level package of every import statement in a source file,
    at any depth (functions included)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_the_reference():
    """No import statement anywhere in `src/repro_torch/` or
    `chip_smoke.py`, at module level or inside a function, names `jax`,
    `jaxlib` or the reference package `repro`."""
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) >= 60
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    names, loaded = set(out[0].split(",")), out[1].strip()
    assert len(names) >= 40
    assert RWKV_MODULES <= names, RWKV_MODULES - names
    assert SERVER_MODULES <= names, SERVER_MODULES - names
    assert TRANSPORT_MODULES <= names, TRANSPORT_MODULES - names
    assert TRAINING_MODULES <= names, TRAINING_MODULES - names
    assert MODEL_TRAINING_MODULES <= names, MODEL_TRAINING_MODULES - names
    assert S2_MODULES <= names, S2_MODULES - names
    assert S3_S7_MODULES <= names, S3_S7_MODULES - names
    assert S4_S5_MODULES <= names, S4_S5_MODULES - names
    assert ANALYSIS_MODULES <= names, ANALYSIS_MODULES - names
    assert MESH_MODULES <= names, MESH_MODULES - names
    assert MESH_SERVE_MODULES <= names, MESH_SERVE_MODULES - names
    assert loaded == "[]", f"repro_torch pulled in: {loaded}"


@pytest.mark.parametrize("module", sorted(TRANSPORT_MODULES
                                          | TRAINING_MODULES
                                          | MODEL_TRAINING_MODULES
                                          | ANALYSIS_MODULES
                                          | MESH_MODULES
                                          | MESH_SERVE_MODULES))
def test_transport_module_alone_loads_no_jax_and_no_reference(module):
    """Each M7, training, model-training, mesh and mesh-serving module
    imported first
    in a fresh interpreter
    (its own import order, the package's re-exports included) loads
    neither JAX nor the reference."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]", f"{module} pulled in: {out}"


def test_transport_entry_points_without_device_raise_where_cuda_is_absent(
        monkeypatch):
    """The M7 entry points that make tensors from nothing mean the card
    without `device` and raise without CUDA; the others run where their
    tensors live, so CPU tensors stay on the CPU."""
    from repro_torch.core import gbma, rng, transport, waveform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = transport.resolve("gbma")
    for call in (lambda: waveform.shaping_waveforms(4, 8),
                 lambda: transport.make_ctx(transport.TransportConfig(),
                                            spec)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert waveform.shaping_waveforms(4, 8, device="cpu").device.type \
        == "cpu"
    v = gbma.ota_aggregate(torch.ones((3, 5)), rng.key(0), ChannelConfig())
    assert v.device.type == "cpu"


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


def test_sweep_server_entry_points_without_device_raise_where_cuda_is_absent(
        monkeypatch):
    """The server, its launcher, `serve_sync` and the cost model's
    calibration mean the card without `device` and raise without CUDA;
    with `device="cpu"` they run."""
    from repro_torch.core.mc import costmodel
    from repro_torch.launch import serve_mc
    from repro_torch.serving.mc_server import McSweepServer, serve_sync

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (McSweepServer, lambda: McSweepServer(device="cuda"),
                 lambda: serve_mc.main(["--selftest"]),
                 lambda: serve_sync([]),
                 lambda: costmodel.calibrate(
                     costmodel.CalibrationConfig.smoke()),
                 costmodel.platform_key):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert McSweepServer(device="cpu").device.type == "cpu"
    assert costmodel.platform_key(device="cpu") == "cpu/1"


def test_measured_cost_model_is_ported_but_placement_is_not():
    """`auto_plan(cost_model="measured")` runs (the analytic plan where
    no calibration entry matches). Placement is ported (M8): a plan over
    at most the call's devices resolves its seed shards, one over more
    raises the reference's oversubscription `ValueError`."""
    from repro_torch.core.mc.plan import auto_plan, resolve_seed_shards

    kw = dict(n_rows=1, seeds=64, steps=10, n_max=8, dim=3,
              memory_budget_bytes=1 << 30)
    assert auto_plan(**kw, cost_model="measured", device="cpu") == \
        auto_plan(**kw)
    for plan, shards in ((ExecPlan(n_shards=2), 2),
                         (ExecPlan(n_shards=0, row_shards=2), 0),
                         (ExecPlan(n_shards=4, seed_chunk=8), 4)):
        assert resolve_seed_shards(plan, 64, device_count=4) == shards
        with pytest.raises(ValueError, match="1 device"):
            resolve_seed_shards(plan, 64, device_count=1)


# placement over several devices is ported: on the one device a port
# call has by default ('cpu'), a placed plan raises the reference's
# oversubscription error; a device list places it
OUT_OF_SLICE = [
    ({"plan": ExecPlan(n_shards=2)}, "2 x 1 shards"),
    ({"plan": ExecPlan(n_shards=2, seed_chunk=2,
                       keep_seed_curves=False)}, "2 x 1 shards"),
]


@pytest.mark.parametrize("kwargs,item", OUT_OF_SLICE)
def test_out_of_slice_arguments_raise(kwargs, item):
    with pytest.raises(ValueError, match=item):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cpu", **kwargs)
    placed = run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
                    device=["cpu", "cpu"], **kwargs)
    plain = run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
                   device="cpu", **{k: v.replace(n_shards=0)
                                    for k, v in kwargs.items()})
    assert placed.plan.n_shards == 2
    np.testing.assert_array_equal(placed.mean, plain.mean)


@pytest.mark.parametrize("algo", ["blind", "blind_ec"])
def test_unported_algorithms_raise(algo):
    """The blind family is ported; as in the reference, it needs the
    edge's antenna count."""
    with pytest.raises(ValueError, match="n_antennas"):
        run_mc(_problem(), [ChannelConfig()], algo, [0.01], 3, 2,
               device="cpu")


def test_mixed_algo_rows_and_node_counts_raise():
    """Every problem kind of the reference is ported; a kind nobody
    registered raises."""
    with pytest.raises(ValueError, match="not registered"):
        problem_from_arrays("svm", {}, 4, 2, device="cpu")


BAD_ARGUMENTS = [
    ({"n_antennas": (2, 3)}, "one antenna count per row"),
    ({"n_antennas": [0]}, "antenna counts must be >= 1"),
    ({"n_antennas": 0}, "antenna counts must be >= 1"),
    ({"power_budget": [1.0, 2.0], "algo": "blind_ec", "n_antennas": 2},
     "one power budget per row"),
    ({"batch_frac": 0.5}, "stochastic problem kind"),
    ({"batch_frac": 0.0}, "batch_frac must be in"),
    ({"batch_frac": [0.5, 0.5]}, "one batch_frac per row"),
]


@pytest.mark.parametrize("kwargs,match", BAD_ARGUMENTS)
def test_antenna_budget_and_batch_arguments_are_checked(kwargs, match):
    """The reference's checks of `n_antennas`, `power_budget` and
    `batch_frac` (a quadratic problem has no minibatch gradient)."""
    kwargs = dict(kwargs)
    algo = kwargs.pop("algo", "gbma")
    with pytest.raises(ValueError, match=match):
        run_mc(_problem(), [ChannelConfig()], algo, [0.01], 3, 2,
               device="cpu", **kwargs)


# ----------------------------------------------------------- serving slice
from repro_torch.configs.registry import PENDING, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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


# the two architectures that S4 and S5 ported, which raised before them
@pytest.mark.parametrize("arch,item", [("llama4-maverick-400b-a17b", "S4"),
                                       ("deepseek-v3-671b", "S5")])
def test_formerly_pending_architectures_resolve(arch, item):
    assert not PENDING, f"{arch} ({item}): PENDING names {PENDING}"
    cfg = get_config(arch)
    assert cfg.arch_id == arch and cfg.n_experts
    assert build_model(cfg).kind == "transformer"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


# MLA's widths (those of reduced deepseek-v3) for a config without them
MLA_DIMS = {"use_mla": True, "q_lora_rank": 64, "kv_lora_rank": 32,
            "qk_nope_dim": 32, "qk_rope_dim": 16, "v_head_dim": 32,
            "head_dim": 48}
# the MoE, MLA and MTP overrides that raised before S4 and S5 (on reduced
# olmo-1b; encdec with whisper's reduced encoder widths), and the two
# architectures reduced
MOE_MLA_CONFIGS = [
    ("olmo-1b", {"n_experts": 4}),
    ("olmo-1b", {"n_experts": 4, "opt_int8_cache": True}),
    ("olmo-1b", MLA_DIMS),
    ("olmo-1b", {"mtp": True}),
    ("olmo-1b", {"family": "encdec", "n_enc_layers": 2, "enc_seq": 16,
                 **MLA_DIMS}),
    ("llama4-maverick-400b-a17b", {}),
    ("deepseek-v3-671b", {}),
]


@pytest.mark.parametrize("arch,overrides", MOE_MLA_CONFIGS)
def test_moe_and_mla_configs_build_and_prefill(arch, overrides):
    """Each builds, prefills 6 tokens into a cache of 8 (the int8 one
    int8, MLA's its latents), decodes a step, and computes finite
    per-example losses (the aux loss positive with MoE layers)."""
    cfg = get_config(arch).reduced().with_(**overrides)
    model = build_model(cfg)
    params = model.init_params(device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 7),
                                     generator=gen)}
    if model.kind == "encdec":
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=gen)
    head = {**batch, "tokens": batch["tokens"][:, :6]}
    logits, cache = model.prefill(params, head, 8)
    kv = cache["seg0"]["sub0"]["kv"]
    if cfg.use_mla:
        assert sorted(kv) == ["c", "k_rope", "pos_ids"]
    else:
        assert kv["k"].dtype == (torch.int8 if cfg.opt_int8_cache
                                 else torch.float32)
    logits2, _ = model.decode_step(params, cache, batch["tokens"][:, 6], 6)
    losses, metrics = model.train_loss_per_example(params, batch)
    assert logits.shape == logits2.shape == (2, cfg.vocab_size)
    assert all(bool(torch.isfinite(t).all()) for t in (logits, logits2,
                                                       losses))
    assert (metrics["aux_loss"] > 0) == bool(cfg.n_experts)


# the structures S3, S6 and S7 ported, which the slices before refused
@pytest.mark.parametrize("arch,kind", [("hymba-1.5b", "hymba"),
                                       ("whisper-small", "encdec"),
                                       ("pixtral-12b", "transformer")])
@pytest.mark.parametrize("opts", [{}, {"opt_int8_cache": True},
                                  {"opt_pad_heads": True},
                                  {"opt_int8_cache": True,
                                   "opt_pad_heads": True}])
def test_ported_config_builds(arch, kind, opts):
    cfg = get_config(arch).with_(**opts)
    assert build_model(cfg).kind == kind
    cache = build_model(cfg.reduced().with_(**opts)).init_cache(
        1, 4, device="cpu")
    leaves = cache["kv"] if kind == "hymba" else cache["seg0"]["sub0"]["kv"]
    assert leaves["k"].dtype == (torch.int8 if opts.get("opt_int8_cache")
                                 else torch.float32)


def test_training_entry_points_raise():
    """Training is ported for the dense decoder (`opt_flash_vjp` builds:
    the port trains through its flash backward either way) and for RWKV
    (T5, done: its loss is differentiable on the CPU); rbg keys (T6) and
    unsafe_rbg keys (T7) build and step; an unknown kind raises; the
    launcher's case is the test below."""
    from repro_torch.optim.gd import gd
    from repro_torch.training.train_step import TrainConfig, build_train_step

    cfg = get_config("repro-100m").reduced()
    assert build_model(cfg.with_(opt_flash_vjp=True)).kind == "transformer"
    rwkv_cfg = get_config("rwkv6-7b").reduced().with_(n_layers=1)
    rwkv = build_model(rwkv_cfg)
    params = rwkv.init_params(device="cpu")
    params["blocks"]["tm"]["wk"].requires_grad_(True)
    losses, _ = rwkv.train_loss_per_example(
        params, {"tokens": torch.zeros((1, 5), dtype=torch.long)})
    losses.sum().backward()
    assert torch.isfinite(params["blocks"]["tm"]["wk"].grad).all()
    assert callable(build_train_step(build_model(cfg),
                                     TrainConfig(rng_impl="rbg"), gd(0.1)))
    model = build_model(cfg)
    step = build_train_step(model, TrainConfig(rng_impl="unsafe_rbg"),
                            gd(0.1))
    params = model.init_params(device="cpu")
    new, _, metrics = step(params, step.init_state(params),
                           {"tokens": torch.zeros((16, 5), dtype=torch.long)},
                           0)
    assert torch.isfinite(metrics["loss"])
    assert not torch.equal(new["embed"], params["embed"])
    with pytest.raises(ValueError, match="rng_impl"):
        build_train_step(model, TrainConfig(rng_impl="philox"), gd(0.1))


def test_train_launcher_without_device_raises_where_cuda_is_absent(
        monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1", "--device", "cuda"])


# ------------------------------------------- node participation and ablations
from repro_torch.figures import run_ablations  # noqa: E402


@pytest.mark.parametrize("participation", [0.0, 1.5, -0.2, [1.0, 0.5]])
def test_participation_outside_the_unit_interval_raises(participation):
    with pytest.raises(ValueError, match="participation"):
        run_mc(_problem(), [ChannelConfig()], "gbma", [0.01], 3, 2,
               device="cpu", participation=participation)


@pytest.mark.parametrize("part", ["d", "f"])
def test_antenna_ablations_raise(part):
    """The antenna ablations are ported: they give their rows, with
    finite values; an unknown part raises."""
    rows = run_ablations(device="cpu", parts=(part,), n=6, steps=2, seeds=1)
    assert len(rows) == {"d": 3, "f": 4}[part]
    assert all(np.isfinite(float(r.rpartition("=")[2])) for r in rows)
    with pytest.raises(ValueError, match="unknown ablation part"):
        run_ablations(device="cpu", parts=(part, "z"), n=6, steps=2, seeds=1)
