"""The training launcher's batches (`repro_torch.launch.train`) against
the reference launcher's, on the CPU.

The reference's `repro.launch.train.main` builds each batch inline: the
`SyntheticTokens` draw, for a VLM zero f32 patch embeddings (B,
n_patches, d_model) and the tokens cut to `seq - n_patches + 1`, for the
encoder-decoder zero f32 frames (B, enc_seq, d_model). Its batches are
read here by running its `main` on the reduced configs with
`run_training` replaced by a recorder; the port's `train_batches` must
give the same arrays, and every reduced family must then train a finite
step through the port's launcher.

At `--seq <= n_patches` the reference's cut `tokens[:, :seq - n_patches
+ 1]` has a stop at or below 0 and takes too few tokens, none at all
where seq + 1 <= n_patches - seq - 1: pixtral-12b at the launcher's
default `--seq 256` trains on an empty (B, 0) slice, a loss over no
label (ROADMAP §3 F16). The port refuses such a `--seq`, naming the
least one.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_helpers import jax_original_layout  # noqa: E402

from repro.launch import train as jax_launch  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402

ARCHS = ["whisper-small", "pixtral-12b", "hymba-1.5b", "olmo-1b"]
BATCH, SEQ, N_BATCHES = 4, 24, 2


def _reference_batches(arch: str, seq: int, monkeypatch) -> list:
    """The first N_BATCHES batches the reference launcher feeds its
    training loop (`--reduced`), as numpy arrays."""
    seen = []

    def record(step, params, state, batches, steps, **kw):
        it = iter(batches)
        for _ in range(N_BATCHES):
            seen.append({k: np.asarray(v) for k, v in next(it).items()})
        return params, state, [{"loss": 0.0}]

    monkeypatch.setattr(jax_launch, "run_training", record)
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--reduced", "--batch", str(BATCH),
        "--seq", str(seq), "--steps", "1"])
    with jax_original_layout():
        jax_launch.main()
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_match_the_reference_launcher(arch, monkeypatch, capsys):
    ref = _reference_batches(arch, SEQ, monkeypatch)
    cfg = get_config(arch).reduced()
    it = launch.train_batches(cfg, BATCH, SEQ)
    ours = [next(it) for _ in range(N_BATCHES)]
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b), arch
        for key in b:
            assert a[key].shape == b[key].shape, (arch, key)
            assert a[key].dtype == b[key].dtype, (arch, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    want = {"whisper-small": {"tokens", "frames"},
            "pixtral-12b": {"tokens", "patch_embed"}}.get(arch, {"tokens"})
    assert set(ours[0]) == want
    if arch == "pixtral-12b":
        assert ours[0]["tokens"].shape == (BATCH, SEQ - cfg.n_patches + 1)
        assert ours[0]["patch_embed"].shape == (BATCH, cfg.n_patches,
                                                cfg.d_model)
    if arch == "whisper-small":
        assert ours[0]["frames"].shape == (BATCH, cfg.enc_seq, cfg.d_model)
        assert ours[0]["frames"].dtype == np.float32


def test_reference_trains_on_an_empty_slice_at_or_below_the_patches(
        monkeypatch, capsys):
    """F16 pinned on reduced pixtral (8 patches): at `--seq 7` the
    reference's cut keeps no token, as pixtral-12b's 1,024 patches do at
    the default `--seq 256` (257 tokens cut at -767)."""
    ref = _reference_batches("pixtral-12b", 7, monkeypatch)
    assert ref[0]["tokens"].shape == (BATCH, 0)
    full = np.zeros((8, 257), np.int32)
    assert full[:, :256 - get_config("pixtral-12b").n_patches + 1].shape \
        == (8, 0)


@pytest.mark.parametrize("seq", [1, 7, 8])
def test_port_refuses_a_seq_at_or_below_the_patches(seq):
    cfg = get_config("pixtral-12b").reduced()
    with pytest.raises(ValueError, match="--seq 9 or more"):
        launch.train_batches(cfg, BATCH, seq)
    with pytest.raises(ValueError, match="--seq 9 or more"):
        launch.main(["--arch", "pixtral-12b", "--reduced", "--seq", str(seq),
                     "--device", "cpu"])
    it = launch.train_batches(cfg, BATCH, 9)
    assert next(it)["tokens"].shape == (BATCH, 2)


def test_full_pixtral_at_the_default_seq_raises_before_any_allocation():
    """`--arch pixtral-12b` at the default `--seq 256` raises naming
    1,025, before the 12 B parameters are drawn (this returns at once)."""
    with pytest.raises(ValueError, match="--seq 1025 or more"):
        launch.main(["--arch", "pixtral-12b", "--device", "cpu"])


@pytest.mark.parametrize("aggregator", ["gbma", "momentum"])
@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b",
                                  "hymba-1.5b"])
def test_launcher_trains_each_family(arch, aggregator, capsys):
    """One reduced step of each new family through the launcher on the
    CPU, on the fused route and through the transport: finite losses."""
    launch.main(["--arch", arch, "--reduced", "--steps", "1", "--batch",
                 "4", "--seq", "24", "--nodes", "2", "--aggregator",
                 aggregator, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"arch={arch} ")
    assert np.isfinite(float(out.rsplit("final loss", 1)[1].split()[0]))
