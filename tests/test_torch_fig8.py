"""Fig. 8 (federated logistic regression) at the reference's full
constants, on the CPU: `repro_torch.figures.run_fig8` against
`benchmarks.fig8_federated_logistic.run` (N in {20, 40, 80}, 300 steps,
4 seeds, blind rows at M = 16, minibatches), every row within 1e-5
relative.

The final excess risk F − F* is small (1.6e-3 at N = 80, centralized)
beside F ≈ 0.5, so a flip of F by one f32 ulp in one of the 4 seeds moves
the row by ~1e-5 relative. The port sums the samples' losses in f64 and
rounds once (`problems._logistic_risk_row`); an f32 sum in PyTorch's
order read 1.34e-5 at that row (ROADMAP §3, F8).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_helpers import jax_original_layout  # noqa: E402

import benchmarks.fig8_federated_logistic as fig8_ref  # noqa: E402
from repro_torch.figures import run_fig8  # noqa: E402


def _values(rows):
    return {row.rsplit(",", 1)[0]: float(row.rsplit(",", 1)[1])
            for row in rows}


def test_fig8_rows_match_reference_at_full_constants():
    with jax_original_layout():
        ref = _values(fig8_ref.run(verbose=False))
    out = _values(run_fig8(device="cpu"))
    assert out.keys() == ref.keys()
    rel = {key: abs(out[key] - ref[key]) / max(abs(ref[key]), 1e-30)
           for key in ref}
    worst = max(rel, key=rel.get)
    print(f"fig8 rows: worst {worst} at {rel[worst]:.3e} relative; N = 80 "
          "centralized "
          f"{rel['fig8a,N=80,frac=0.5,final_excess,centralized']:.3e}")
    assert rel[worst] <= 1e-5, (worst, out[worst], ref[worst])
