"""The port's discrepancy metrics against the JAX package's.

Same numpy designs through `dmosopt_tpu.discrepancy` and
`dmosopt_tpu_torch.discrepancy`: each metric of a float32 design agrees
within rtol 1e-5 (float32 products over d factors and n² pairs), a
batch of designs gives each design's own value, and `all_metrics` has
the same keys and values.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import discrepancy as JD
from dmosopt_tpu_torch import discrepancy as TD

NAMES = ("MD2", "CD2", "SD2", "WD2", "MinDist")


def _design(seed, n=24, d=5):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_jax(name):
    X = _design(3)
    want = float(getattr(JD, name)(jnp.asarray(X)))
    got = float(getattr(TD, name)(torch.as_tensor(X)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a leading batch of designs scores each design on its own
    Xb = np.stack([X, _design(4)])
    batched = getattr(TD, name)(torch.as_tensor(Xb)).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            batched[b], float(getattr(JD, name)(jnp.asarray(Xb[b]))), rtol=1e-5)


def test_all_metrics_match_jax():
    X = _design(7, n=16, d=3)
    want, got = JD.all_metrics(X), TD.all_metrics(X)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
