"""The port's constrained sampling against the JAX package.

The parser, dependency resolution and bounds are copies of the JAX
package's numpy code and the designs come from the port's `sampling`,
so a seed gives bit-equal values: on tests/test_constrained_sampling.py's
reference demo space, on chained dependencies and on the
over-constrained fallback; a circular dependency raises the same error.
Evolutionary children with the JAX package's draws injected (pair picks,
operator bits, SBX and mutation uniforms) agree within 1e-5; the
children call is one SBX and two mutation calls, which on a card are one
`launch_sbx` and two `launch_mutation` launches.
"""

import numpy as np
import pytest
import jax
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import constrained_sampling as jax_cs
from dmosopt_tpu_torch import constrained_sampling as port_cs

DEMO_SPACE = {
    "gc": [0.01, 50],
    "soma_gnabar": [0.1, 50],
    "soma_gl": [0.001, 0.6],
    "soma_gkdrbar": {
        "abs": [0.0, 60.0],
        "lb": [("gc", "+ 5")],
        "ub": [("gc", "+ 10")],
        "method": ("uniform", None, None),
    },
    "soma_gkahpbar": {
        "abs": [0.001, 0.6],
        "method": ("normal", 0, 200),
    },
}
CHAINED_SPACE = {
    "a": [0.0, 1.0],
    "b": {"abs": [0.0, 10.0], "lb": [("a", "+ 1")], "ub": [("a", "+ 2")],
          "method": ("uniform",)},
    "c": {"abs": [0.0, 20.0], "lb": [("b", "* 2")], "ub": [("b", "* 3")],
          "method": ("percentile", 0.5)},
    "d": {"abs": [0.0, 5.0], "lb": [("a", "* 1")], "ub": [("b", "* 1 max 3")],
          "method": ("uniform",)},
}
OVER_SPACE = {
    "a": [5.0, 6.0],
    "b": {"abs": [0.0, 1.0], "lb": [("a", "+ 1")], "ub": [("a", "+ 2")],
          "method": ("uniform",)},
}


@pytest.mark.parametrize("space,n,seed,method", [
    (DEMO_SPACE, 50, 1, None), (CHAINED_SPACE, 20, 2, None),
    (OVER_SPACE, 10, 3, None), (DEMO_SPACE, 7, 4, "slh"),
])
def test_values_bit_equal_jax(space, n, seed, method):
    want = jax_cs.ParamSpacePoints(n, space, Method=method, seed=seed)
    got = port_cs.ParamSpacePoints(n, space, Method=method, seed=seed)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.as_dict().keys() == want.as_dict().keys()


def test_parser_and_circular_dependency_match_jax():
    env = {"a": np.array([2.0, 4.0]), "b": np.array([10.0, 20.0])}
    for text in ("1 + 2 * 3", "2 ** 3 ** 0.5", "(a + 1) * -b", "a max 3 min b / 4"):
        np.testing.assert_array_equal(
            port_cs.BoundExpression(text).evaluate(env),
            jax_cs.BoundExpression(text).evaluate(env),
        )
    assert port_cs.tokenize("a ** 2 + max") == jax_cs.tokenize("a ** 2 + max")
    space = {
        "a": {"abs": [0, 1], "lb": [("b", "* 1")], "method": ("uniform",)},
        "b": {"abs": [0, 1], "lb": [("a", "* 1")], "method": ("uniform",)},
    }
    with pytest.raises(ValueError, match="circular") as want:
        jax_cs.ParamSpacePoints(5, space, seed=0)
    with pytest.raises(ValueError, match="circular") as got:
        port_cs.ParamSpacePoints(5, space, seed=0)
    assert str(got.value) == str(want.value)


def _jax_draws(seed_int, npairs, P, n, crossover_rate):
    """The draws of the JAX package's `_get_children` from the key its
    numpy stream gives (``constrained_sampling.py:359-401``)."""
    key = jax.random.PRNGKey(seed_int)
    k_pick, k_op, k_sbx, k_mut = jax.random.split(key, 4)
    i1 = jax.random.randint(k_pick, (npairs,), 0, P)
    shift = jax.random.randint(jax.random.fold_in(k_pick, 1), (npairs,), 1, P)
    u = lambda k: torch.as_tensor(np.array(jax.random.uniform(k, (npairs, n))))  # noqa: E731
    return {
        "i1": torch.as_tensor(np.array(i1), dtype=torch.int64),
        "i2": torch.as_tensor(np.array((i1 + shift) % P), dtype=torch.int64),
        "is_x": torch.as_tensor(np.array(jax.random.bernoulli(k_op, crossover_rate, (npairs,)))),
        "u_sbx": u(k_sbx),
        "u_m1": u(k_mut),
        "u_m2": u(jax.random.fold_in(k_mut, 1)),
    }


def test_evolutionary_children_match_jax_with_its_draws():
    rng = np.random.default_rng(0)
    parents = rng.uniform(0.2, 0.8, size=(16, 3)).astype(np.float32)
    space = {"x": [0.0, 1.0], "y": [0.0, 2.0], "z": [-1.0, 1.0]}
    parents_dict = {"params": np.array(["x", "y", "z"]), "values": parents,
                    "crossover_rate": 0.7, "di_crossover": [1.0, 5.0, 15.0]}
    want = jax_cs.ParamSpacePoints(20, space, seed=4, parents=parents_dict).values
    seed_int = int(np.random.default_rng(4).integers(0, 2**31 - 1))
    draws = _jax_draws(seed_int, 10, 16, 3, 0.7)
    assert 0 < int(draws["is_x"].sum()) < 10
    xlb = torch.tensor([0.0, 0.0, -1.0])
    xub = torch.tensor([1.0, 2.0, 1.0])
    got = port_cs.children_core(
        torch.as_tensor(parents), draws, torch.tensor([1.0, 5.0, 15.0]),
        torch.full((3,), 20.0), xlb, xub, torch.tensor(1.0 / 3.0),
    )
    np.testing.assert_allclose(
        np.clip(got.numpy(), xlb.numpy(), xub.numpy()), want, atol=1e-5
    )


def test_children_on_the_device_and_their_calls(monkeypatch):
    """A children call makes one SBX and two mutation calls; the
    children lie in the box; without a card the default device raises."""
    from dmosopt_tpu_torch.ops import variation

    calls = []
    for name in ("sbx", "mutation"):
        fn = getattr(variation, name)
        monkeypatch.setattr(port_cs, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(1)
    parents = {"params": np.array(["x", "y"]), "values": rng.uniform(size=(6, 2))}
    space = {"x": [0.0, 1.0], "y": [0.0, 1.0]}
    ps = port_cs.ParamSpacePoints(12, space, seed=2, parents=parents, device="cpu")
    assert ps.values.shape == (12, 2)
    assert np.all((ps.values >= 0.0) & (ps.values <= 1.0))
    assert sorted(calls) == ["mutation", "mutation", "sbx"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cs.ParamSpacePoints(4, space, seed=2, parents=parents)
