"""The port's sweep-server launcher (`repro_torch.launch.serve_mc`) on the
CPU: `--selftest` (one program shape per distinct signature, each
demuxed request within 1e-6 of a solo `run_mc`) and `--selftest --chaos`
(a retried chunk fault bit for bit, a retried quantum, a mid-run deadline
against a dedicated run over the completed seeds, on a virtual clock)
exit 0, and the demo mix prints its batches."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve_mc  # noqa: E402


@pytest.mark.parametrize("argv,verdicts", [
    (["--selftest"], ("selftest PASS",)),
    (["--selftest", "--chaos"], ("selftest PASS", "chaos PASS")),
])
def test_selftest_exits_zero(argv, verdicts, capsys):
    with pytest.raises(SystemExit) as done:
        serve_mc.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    assert "FAIL" not in out
    for verdict in verdicts:
        assert verdict in out


def test_demo_mix_prints_its_batches(capsys):
    serve_mc.main(["--device", "cpu", "--steps", "8", "--seeds", "4"])
    out = capsys.readouterr().out
    assert "5 requests -> 3 coalesced batches, 3 program shapes" in out
    assert out.count("request ") >= 5
