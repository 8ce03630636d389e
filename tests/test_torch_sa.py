"""The port's sensitivity analysis against the JAX package.

FAST's search curves and DGSM's seeded design are the JAX package's
numpy code, so the designs are bit-equal; the spectrum and derivative
reductions are too, so the same analytic model gives `S1` and `ST`
within 1e-9 relative. `moasmo.analyze_sensitivity` on a JAX GP fit
carried across with `interop.gp_fit_from_arrays` (the port's surrogate
evaluating the whole design in one batched call) gives the JAX
package's per-gene distribution indices within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import moasmo as jax_moasmo
from dmosopt_tpu import sa as jax_sa
from dmosopt_tpu.models import gp as jax_gp
from dmosopt_tpu_torch import interop
from dmosopt_tpu_torch import moasmo as port_moasmo
from dmosopt_tpu_torch import sa as port_sa
from dmosopt_tpu_torch.models import gp as port_gp

NAMES, OUTS = ["x0", "x1", "x2"], ["f0", "f1"]


class _QuadModel:
    """tests/test_feasibility_sa.py's model: y0 depends strongly on x0,
    weakly on x1, not at all on x2."""

    def evaluate(self, X):
        X = np.asarray(X)
        y0 = 10.0 * X[:, 0] + 0.5 * X[:, 1]
        y1 = 5.0 * X[:, 1] ** 2
        return np.column_stack([y0, y1])


class _TorchQuadModel(_QuadModel):
    """The same model answering with a tensor, as the port's surrogate
    does."""

    def evaluate(self, X):
        return torch.as_tensor(super().evaluate(X))


@pytest.mark.parametrize("name,kwargs", [
    ("SA_FAST", {"num_samples": 2048}),
    ("SA_DGSM", {"num_samples": 400}),
])
def test_designs_and_indices_equal_jax(name, kwargs):
    lb, ub = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 5.0])
    jsa = getattr(jax_sa, name)(lb, ub, NAMES, OUTS)
    psa = getattr(port_sa, name)(lb, ub, NAMES, OUTS)
    np.testing.assert_array_equal(
        psa.sample(num_samples=kwargs["num_samples"]),
        jsa.sample(num_samples=kwargs["num_samples"]),
    )
    want = jsa.analyze(_QuadModel(), **kwargs)
    for model in (_QuadModel(), _TorchQuadModel()):
        got = psa.analyze(model, **kwargs)
        assert got.keys() == want.keys()
        for key in want:
            for out in OUTS:
                np.testing.assert_allclose(got[key][out], want[key][out], rtol=1e-9)


@pytest.fixture(scope="module")
def gp_fits():
    """A small JAX GP fit (3 parameters, 2 objectives) and the port's
    surrogate carrying the same fit."""
    rng = np.random.default_rng(0)
    xlb, xub = np.zeros(3), np.ones(3)
    X = rng.uniform(size=(24, 3))
    Y = np.column_stack([np.sin(3.0 * X[:, 0]) + 0.2 * X[:, 1], X[:, 1] ** 2 + 0.1 * X[:, 2]])
    jsm = jax_gp.GPR_Matern(X, Y, 3, 2, xlb, xub, n_starts=2, n_iter=20, seed=0)
    psm = port_gp.GPR_Matern(X, Y, 3, 2, xlb, xub, n_starts=1, n_iter=1, seed=0,
                             device="cpu")
    psm.fit = interop.gp_fit_from_arrays(
        {k: np.asarray(v) for k, v in jsm.fit._asdict().items()}, "cpu"
    )
    return jsm, psm, xlb, xub


@pytest.mark.parametrize("method", ["fast", "dgsm"])
def test_analyze_sensitivity_on_a_carried_fit_matches_jax(gp_fits, method):
    jsm, psm, xlb, xub = gp_fits
    want = jax_moasmo.analyze_sensitivity(
        jsm, xlb, xub, NAMES, OUTS, sensitivity_method_name=method,
        sensitivity_method_kwargs={},
    )
    got = port_moasmo.analyze_sensitivity(
        psm, xlb, xub, NAMES, OUTS, sensitivity_method_name=method,
        sensitivity_method_kwargs={},
    )
    for key in ("di_mutation", "di_crossover"):
        assert got[key].shape == (3,) and got[key].max() == pytest.approx(20.0)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3)


def test_no_sensitivity_method_gives_no_indices():
    out = port_moasmo.analyze_sensitivity(None, np.zeros(2), np.ones(2), ["a", "b"], OUTS)
    assert out == {"di_mutation": None, "di_crossover": None}
