"""The port's fused NSGA-II offspring step against the JAX package.

`_offspring_core` is what a CPU tensor runs and what the fused Triton
kernel is held to on the card by chip_smoke.py. From the same seeded
numpy inputs (population, mating pool, pair and gene uniforms), its
offspring must equal the JAX generation's
``concatenate([where(is_x, c1, m1), where(is_x, c2, m2)])``, with c1, c2,
m1 and m2 from the JAX dense cores and from the Pallas kernels in
interpret mode (as tests/test_ops.py runs them), to rtol 1e-6 / atol
1e-7 (the same float32 arithmetic, with pow and division rounded by
different libraries); the operator tags must be exactly equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.ops import variation as JV
from dmosopt_tpu_torch.ops import variation as TV

RTOL, ATOL = 1e-6, 1e-7
F32 = np.float32


def _inputs(pop, poolsize, n, seed):
    rng = np.random.default_rng(seed)
    npairs = pop // 2
    xlb = (-1.0 + 0.5 * rng.random(n)).astype(F32)
    xub = (1.0 + rng.random(n)).astype(F32)
    parm = (xlb + (xub - xlb) * rng.random((pop, n))).astype(F32)
    return {
        "parm": parm,
        "pool_idx": rng.permutation(pop)[:poolsize].astype(np.int64),
        "r": rng.random((3, npairs), dtype=F32),
        "u": rng.random((3, npairs, n), dtype=F32),
        "pc": F32(0.6), "pm": F32(0.4), "rate": F32(1.0 / n),
        "di_c": (1.0 + 4.0 * rng.random(n)).astype(F32),
        "di_m": (15.0 + 10.0 * rng.random(n)).astype(F32),
        "xlb": xlb, "xub": xub,
    }


def _jax_offspring(a, pool_n, shift_hi, pallas):
    """The JAX generation's offspring from injected indices and uniforms
    (``dmosopt_tpu/optimizers/nsga2.py:176-192``)."""
    r = a["r"]
    i1 = (r[0] * F32(pool_n)).astype(np.int64)
    i2 = (i1 + 1 + (r[1] * F32(shift_hi - 1)).astype(np.int64)) % pool_n
    p1, p2 = a["parm"][a["pool_idx"][i1]], a["parm"][a["pool_idx"][i2]]
    sbx = JV._sbx_pallas if pallas else jax.jit(JV._sbx_core)
    mut = JV._mutation_pallas if pallas else jax.jit(JV._mutation_core)
    c1, c2 = sbx(a["u"][0], p1, p2, a["di_c"], a["xlb"], a["xub"])
    m1 = mut(a["u"][1], p1, a["di_m"], a["xlb"], a["xub"], a["rate"])
    m2 = mut(a["u"][2], p2, a["di_m"], a["xlb"], a["xub"], a["rate"])
    pc, pm = jnp.float32(a["pc"]), jnp.float32(a["pm"])
    is_x = jnp.asarray(r[2]) < (2.0 * pc) / (2.0 * pc + pm)
    o1 = jnp.where(is_x[:, None], c1, m1)
    o2 = jnp.where(is_x[:, None], c2, m2)
    return np.asarray(jnp.concatenate([o1, o2], axis=0)), np.asarray(is_x)


def _torch_args(a, pool_n, shift_hi):
    t = torch.as_tensor
    # the bounds as the optimizer passes them: strided columns of (n, 2)
    bounds = t(np.stack([a["xlb"], a["xub"]], axis=1))
    return (t(a["parm"]), t(a["pool_idx"]), t(a["r"]), t(a["u"]), pool_n,
            shift_hi, t(a["pc"]), t(a["pm"]), t(a["rate"]), t(a["di_c"]),
            t(a["di_m"]), bounds[:, 0], bounds[:, 1])


@pytest.mark.parametrize(
    "pop,poolsize,n,pool_n,adaptive",
    [(40, 20, 5, 20, False), (200, 100, 30, 100, False), (40, 20, 5, 7, True)],
)
def test_offspring_core_matches_jax_cores_and_pallas(
    pop, poolsize, n, pool_n, adaptive, monkeypatch
):
    monkeypatch.setenv("DMOSOPT_PALLAS", "1")
    a = _inputs(pop, poolsize, n, seed=pop + n + pool_n)
    # the pool size is a 0-d int32 tensor in both modes: made once when
    # fixed, the live pool size (device state, shift bound >= 2) when
    # adaptive
    shift_hi = max(pool_n, 2) if adaptive else pool_n
    tp = torch.tensor(pool_n, dtype=torch.int32)
    ts = torch.tensor(shift_hi, dtype=torch.int32)
    before = dict(TV.KERNEL_LAUNCHES)
    got, got_x = TV.offspring(*_torch_args(a, tp, ts))
    assert TV.KERNEL_LAUNCHES == before  # a CPU tensor takes the plain core
    assert got.shape == (2 * (pop // 2), n) and got_x.dtype == torch.bool
    assert 0 < int(got_x.sum()) < pop // 2  # both operators occur
    for pallas in (False, True):
        want, want_x = _jax_offspring(a, pool_n, shift_hi, pallas)
        np.testing.assert_array_equal(got_x.numpy(), want_x)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pair_indices_are_distinct_and_in_the_live_pool():
    """Over seeded draws, the extremes of [0, 1) included, and pool sizes
    from 1 up, fixed (shift bound ``pool_n``) and adaptive (shift bound
    ``max(pool_n, 2)``), as 0-d tensors as the generation passes them:
    every index is below ``pool_n``, and the two parents differ whenever
    ``pool_n >= 2``."""
    rng = np.random.default_rng(0)
    below_one = np.nextafter(F32(1), F32(0))
    for pool_n in [1, 2, 3, 7, 64, 100, 1000, 65536]:
        r = rng.random((2, 512), dtype=F32)
        r[:, :4] = [[0, 0, below_one, below_one], [0, below_one, 0, below_one]]
        r = torch.as_tensor(r)
        for sh in (pool_n, max(pool_n, 2)):
            pn = torch.tensor(pool_n, dtype=torch.int32)
            i1, i2 = TV._pair_indices(r, pn, torch.tensor(sh, dtype=torch.int32))
            for i in (i1, i2):
                assert int(i.min()) >= 0 and int(i.max()) < pool_n
            if pool_n >= 2:
                assert bool((i1 != i2).all()), pool_n
