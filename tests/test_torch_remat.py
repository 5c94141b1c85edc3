"""The per-layer recompute (`cfg.remat`) in the port's training forward,
on the CPU.

The reference wraps each layer body in `jax.checkpoint(...,
nothing_saveable)` when `cfg.remat` is set (its default): the decoder's
scan step (`transformer.decoder_forward`), hymba's layer, whisper's
encoder layer, RWKV's block and deepseek-v3's MTP head. The port runs the
same bodies under `torch.utils.checkpoint` (`layers.remat`). On the
reduced hymba, whisper, pixtral, olmo-1b, rwkv6-7b and deepseek-v3 (MoE,
MLA and the MTP head), each in f32 with `remat=True`:

* the gradients equal those without the recompute bit for bit;
* they match the reference's `remat=True` gradients, every leaf within
  1e-4 of its largest magnitude and the losses within 1e-5 relative
  (the bar `test_torch_train_models.py` holds the models' gradients at);
* the bytes kept for the backward outside the recomputed layers
  (counted by `saved_tensors_hooks`) fall;
* each layer's kernel runs twice a forward and backward: K2's route
  (`flash_vjp._forward`) and the WKV route are counted.

`ModelConfig.reduced()` keeps `remat=False`, as the reference's does.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.configs.registry import _MODULES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import flash_vjp, rwkv  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["hymba-1.5b", "whisper-small", "pixtral-12b", "olmo-1b",
         "rwkv6-7b", "deepseek-v3-671b"]
B, S = 2, 20
LOSS_RTOL = 1e-5
GRAD_BAR = 1e-4  # of each leaf's largest |g|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed: int = 5) -> dict:
    """(B, S + 1) tokens and, as the model takes them, f32 frames or
    patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1),
                                  dtype=np.int32)}
    if cfg.n_patches:
        out["patch_embed"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _grads(cfg, params, batch, count=None) -> tuple:
    """(per-example losses, gradient leaves of the mean loss, bytes the
    autograd graph keeps outside recomputed layers)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        losses, _ = build_model(cfg).train_loss_per_example(
            leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    torch.mean(losses).backward()
    return losses.detach(), [p.grad for p in tree_leaves(leaves)], kept[0]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(arch, the reference's initial params as numpy, the batch)."""
    arch = request.param
    jcfg = jax_get_config(arch).reduced()
    with jax_original_layout():
        jparams = jax_build_model(jcfg).init_params(jax.random.key(0))
    return arch, jax.tree.map(np.asarray, jparams), _batch(jcfg)


def test_recompute_changes_no_bit(case):
    arch, init, batch = case
    cfg = get_config(arch).reduced()
    params = params_from_reference(init)
    loss0, plain, kept0 = _grads(cfg, params, batch)
    loss1, remat, kept1 = _grads(cfg.with_(remat=True), params, batch)
    assert torch.equal(loss0, loss1)
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert (a is None and b is None) or torch.equal(a, b), arch
    print(f"{arch}: {kept0:,} bytes kept for the backward without the "
          f"recompute, {kept1:,} with it")
    assert kept1 < kept0 / 2, arch


def test_recompute_matches_the_reference(case):
    arch, init, batch = case
    jcfg = jax_get_config(arch).reduced().with_(remat=True)
    with jax_original_layout():
        model = jax_build_model(jcfg)

        def mean_loss(p):
            losses, _ = model.train_loss_per_example(
                p, {k: jnp.asarray(v) for k, v in batch.items()})
            return jnp.mean(losses), losses

        (_, ref_losses), ref_grads = jax.value_and_grad(
            mean_loss, has_aux=True)(jax.tree.map(jnp.asarray, init))
    ref_grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads)]
    losses, grads, _ = _grads(get_config(arch).reduced().with_(remat=True),
                              params_from_reference(init), batch)
    loss_rel = float(np.max(np.abs(losses.numpy() - np.asarray(ref_losses))
                            / np.abs(np.asarray(ref_losses))))
    assert loss_rel <= LOSS_RTOL, arch
    assert len(grads) == len(ref_grads)
    worst = 0.0
    for g, r in zip(grads, ref_grads):
        top = float(np.max(np.abs(r)))
        if g is None:  # a leaf no loss term reaches (deepseek's router bias)
            assert top == 0.0, arch
            continue
        err = float(np.max(np.abs(g.numpy() - r)))
        worst = max(worst, err / max(top, 1e-30))
        assert err <= GRAD_BAR * top, (arch, tuple(g.shape))
    print(f"{arch}: losses {loss_rel:.3e} rel, gradients within "
          f"{worst:.3e} of each leaf's largest (bar {GRAD_BAR})")


@pytest.mark.parametrize("arch,route", [("olmo-1b", "attention"),
                                        ("whisper-small", "attention"),
                                        ("hymba-1.5b", "attention"),
                                        ("rwkv6-7b", "wkv")])
def test_each_layer_runs_twice_with_the_recompute(arch, route, monkeypatch):
    """K2's forward (`flash_vjp._forward`) or the WKV route runs once an
    attention (or RWKV) layer a forward and backward without the
    recompute, twice with it: on the card each launch of the kernel
    doubles (chip_smoke's "train models" counts)."""
    calls = [0]
    if route == "attention":
        inner = flash_vjp._forward

        def counted(*a, **kw):
            calls[0] += 1
            return inner(*a, **kw)

        monkeypatch.setattr(flash_vjp, "_forward", counted)
    else:
        inner = rwkv.wkv6

        def counted(*a, **kw):
            calls[0] += 1
            return inner(*a, **kw)

        monkeypatch.setattr(rwkv, "wkv6", counted)
    cfg = get_config(arch).reduced()
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec"
                             else 0)
    params = build_model(cfg).init_params(device="cpu")
    batch = _batch(cfg)
    for remat, want in ((False, layers), (True, 2 * layers)):
        calls[0] = 0
        _grads(cfg.with_(remat=remat), params, batch)
        assert calls[0] == want, (arch, remat)


@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_remat_defaults_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.remat == jcfg.remat
    assert cfg.reduced().remat is False
    assert jcfg.reduced().remat is False
