"""The port's front-fill survival against the JAX package.

`front_fill_selection` takes whole fronts while they fit and breaks the
first front that overflows by crowding within it. On tie-free sets (d = 2
and 3) with the cut inside a front, the picked indices, the chosen mask
and the ranks must be exactly equal, and the mid-front crowding allclose
(rtol 1e-6).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers.survival import front_fill_selection as jax_fill
from dmosopt_tpu_torch.optimizers.survival import front_fill_selection

N = 60


def _cut_inside_a_front(y):
    """A population size that ends inside the first front of three or
    more rows after front 0."""
    rank = np.asarray(jax.jit(lambda a: jax_fill(a, 1)[2])(jnp.asarray(y)))
    sizes = np.bincount(rank)
    k = next(i for i in range(1, len(sizes)) if sizes[i] >= 3)
    return int(sizes[:k].sum()) + sizes[k] // 2


@pytest.mark.parametrize("d", [2, 3])
def test_front_fill_selection_matches_jax(d):
    y = np.random.default_rng(d).random((N, d)).astype(np.float32)
    pop = _cut_inside_a_front(y)
    want = [np.asarray(a) for a in jax_fill(jnp.asarray(y), pop)]
    got = [a.numpy() for a in front_fill_selection(torch.as_tensor(y), pop)]
    for name, g, w in zip(("sel_idx", "chosen", "rank"), got[:3], want[:3]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-7)
    assert got[1].sum() == pop and (got[3] > 0).sum() >= 3  # a broken front


def test_front_fill_selection_reuses_given_rank_and_crowding():
    y = np.random.default_rng(5).random((N, 3)).astype(np.float32)
    pop = _cut_inside_a_front(y)
    sel, chosen, rank, crowd = front_fill_selection(torch.as_tensor(y), pop)
    again = front_fill_selection(torch.as_tensor(y), pop, rank=rank, crowding=crowd)
    np.testing.assert_array_equal(again[0].numpy(), sel.numpy())
    np.testing.assert_array_equal(again[1].numpy(), chosen.numpy())
