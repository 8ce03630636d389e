"""AGE-MOEA buckets: the stacked survival against the JAX package's
``jax.vmap`` of it, and a batched AGE-MOEA epoch against the port's own
sequential route.

- `environmental_selection` and `_survival_score` on stacked inputs of
  T = 3 tenants (masks with unequal live rows, spread points of the
  DTLZ2 sphere so the greedy margins sit far above float32 rounding)
  against ``jax.vmap`` of the JAX functions: survivors ``perm[:pop]``
  and ranks exactly equal, scores, normalizations and p allclose at
  float32 (rtol 1e-5, infinities equal). The stacked survival, greedy
  loop included, equals each tenant's own call bit for bit.
- `run_bucket_epoch` of two AGE-MOEA tenants against the sequential
  `initialize_epoch`, tenant by tenant, bitwise on the CPU (the EA's
  final states, the resample rows, the generation index); the same
  bucket with two tenants' generators swapped differs, so the check
  can fail.
- Two AGE-MOEA tenants of the service share one bucket, and the task
  graph (concurrency 2) streams the lockstep fronts bitwise.

Every JAX reference is one ``jax.jit`` program, compiled once in a
module-scoped fixture.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.optimizers import agemoea as JA
from dmosopt_tpu_torch import interop, tenants
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.driver import dopt_init
from dmosopt_tpu_torch.optimizers import agemoea as TA
from dmosopt_tpu_torch.service import OptimizationService

T, N, N_X, POP = 3, 40, 6, 20


def _stacked(d, seed):
    """(x, y, mask) of T tenants: per tenant N rows, half on the unit
    sphere's positive orthant, half pushed out by 5-60%; tenant t keeps
    N - 4t live rows."""
    rng = np.random.default_rng(seed)
    xs, ys, ms = [], [], []
    for t in range(T):
        v = np.abs(rng.standard_normal((N, d))) + 0.05
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = np.ones(N)
        r[N // 2:] += rng.uniform(0.05, 0.6, N // 2)
        ys.append((v * r[:, None]).astype(np.float32))
        xs.append(rng.random((N, N_X)).astype(np.float32))
        m = np.ones(N, bool)
        m[rng.permutation(N)[: 4 * t]] = False
        ms.append(m)
    return np.stack(xs), np.stack(ys), np.stack(ms)


@pytest.fixture(scope="module")
def jax_fns():
    select = jax.jit(jax.vmap(
        lambda x, y, m: JA.environmental_selection(x, y, POP, mask=m)))
    score = jax.jit(jax.vmap(JA._survival_score))
    return select, score


@pytest.mark.parametrize("d", [3, 5])
def test_stacked_selection_matches_vmapped_jax(jax_fns, d):
    x, y, m = _stacked(d, seed=d)
    jp, jr, jc = (np.asarray(a) for a in jax_fns[0](jnp.asarray(x), jnp.asarray(y),
                                                    jnp.asarray(m)))
    tp, tr, tc = (a.numpy() for a in TA.environmental_selection(
        torch.as_tensor(x), torch.as_tensor(y), POP, mask=torch.as_tensor(m)))
    np.testing.assert_array_equal(tp[:, :POP], jp[:, :POP])
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    for t in range(T):
        # the stacked call equals each tenant's own, bit for bit
        own = TA.environmental_selection(
            torch.as_tensor(x[t]), torch.as_tensor(y[t]), POP,
            mask=torch.as_tensor(m[t]))
        for a, b in zip(own, (tp[t], tr[t], tc[t])):
            np.testing.assert_array_equal(a.numpy(), b)


def test_stacked_survival_score_matches_vmapped_jax(jax_fns):
    _, y, m = _stacked(4, seed=9)
    yt = torch.as_tensor(y)
    rank = TA.non_dominated_rank(yt, mask=torch.as_tensor(m))
    front = ((rank == 0) & torch.as_tensor(m))
    ideal = torch.where(front[..., None], yt, torch.inf).amin(dim=-2)
    want = [np.asarray(a) for a in jax_fns[1](jnp.asarray(y), jnp.asarray(front.numpy()),
                                              jnp.asarray(ideal.numpy()))]
    got = [a.numpy() for a in TA._survival_score(yt, front, ideal)]
    for w, g, name in zip(want, got, ("normalization", "p", "scores")):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
    assert np.isinf(got[2]).sum(axis=1).min() >= 4  # the corner solutions
    for t in range(T):
        own = TA._survival_score(yt[t], front[t], ideal[t])
        for a, b in zip(own, got):
            np.testing.assert_array_equal(a.numpy(), b[t])


def test_stacked_update_from_a_carried_jax_state(jax_fns):
    """A T-stacked JAX `AGEMOEAState`, carried over through `interop`,
    updated by ``jax.vmap`` of the JAX `update_strategy` and by the
    port's stacked one: populations and ranks exactly equal, scores
    allclose."""
    d = 3
    x, y, _ = _stacked(d, seed=4)
    bounds = np.stack([np.zeros(N_X), np.ones(N_X)], axis=1).astype(np.float32)
    jopt = JA.AGEMOEA(popsize=POP, nInput=N_X, nOutput=d, model=None)
    perm, rank, crowd = (np.asarray(a) for a in jax_fns[0](
        jnp.asarray(x), jnp.asarray(y), jnp.ones((T, N), bool)))
    keep = perm[:, :POP]
    take = lambda a: np.take_along_axis(a, keep if a.ndim == 2 else keep[..., None], 1)  # noqa: E731
    jstate = JA.AGEMOEAState(
        population_parm=jnp.asarray(take(x)), population_obj=jnp.asarray(take(y)),
        rank=jnp.asarray(take(rank)), crowd_dist=jnp.asarray(take(crowd)),
        bounds=jnp.asarray(np.stack([bounds] * T)), n_active=jnp.full((T,), POP, jnp.int32),
    )
    x_gen, y_gen = _stacked(d, seed=5)[:2]
    x_gen, y_gen = x_gen[:, :POP], y_gen[:, :POP] * 0.98
    want = jax.jit(jax.vmap(jopt.update_strategy))(
        jstate, jnp.asarray(x_gen), jnp.asarray(y_gen))
    topt = TA.AGEMOEA(popsize=POP, nInput=N_X, nOutput=d, model=None, device="cpu")
    carried = interop.stacked_agemoea_state_from_arrays(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu")
    got = topt.update_strategy(carried, torch.as_tensor(x_gen), torch.as_tensor(y_gen))
    for name in ("population_parm", "population_obj", "rank", "n_active"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.crowd_dist.numpy(), np.asarray(want.crowd_dist),
                               rtol=1e-5)


# ------------------------------------------------ bucket vs sequential


def _params(opt_id, **over):
    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(4)}, "problem_parameters": {},
        "n_initial": 3, "n_epochs": 2, "population_size": 16, "num_generations": 6,
        "resample_fraction": 0.5, "optimizer_name": "age",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 30, "seed": 0},
        "random_seed": 19, "problem_ids": {0, 1}, "device": "cpu",
    }
    params.update(over)
    return params


def _epoch(opt_id, min_bucket=2):
    dopt = dopt_init(_params(opt_id), initialize_strategy=True)
    dopt._process_requests()
    routing = tenants.initialize_epochs_batched(dopt.optimizer_dict, 0,
                                                min_bucket=min_bucket)
    return dopt, routing


def _same(seq, bat):
    """Whether every tenant's batched epoch equals its sequential one."""
    for pid in (0, 1):
        rs, rb = seq.optimizer_dict[pid].opt_gen, bat.optimizer_dict[pid].opt_gen
        ss, sb = rs["optimizer"].state, rb["optimizer"].state
        for f in ("population_parm", "population_obj", "rank", "crowd_dist"):
            if not torch.equal(getattr(ss, f), getattr(sb, f)):
                return False
        for k in ("x_resample", "y_pred", "gen_index", "x_sm", "y_sm"):
            if not np.array_equal(rs[k], rb[k]):
                return False
    return True


def test_age_bucket_epoch_equals_sequential_bitwise(monkeypatch):
    seq, routing = _epoch("age_seq", min_bucket=3)
    assert routing == {0: "sequential", 1: "sequential"}
    bat, routing = _epoch("age_bat")
    assert routing == {0: "batched", 1: "batched"}
    assert bat.optimizer_dict[0].opt_gen["stats"]["n_generations"] == 6
    assert _same(seq, bat)
    # a bucket that hands tenant 0 tenant 1's draws (and back) must fail
    orig = TA.AGEMOEA.generate_strategy

    def swapped(self, generator, state):
        if isinstance(generator, list):
            generator = generator[::-1]
        return orig(self, generator, state)

    monkeypatch.setattr(TA.AGEMOEA, "generate_strategy", swapped)
    bad, _ = _epoch("age_swapped")
    assert not _same(seq, bad)


def test_age_tenants_share_a_service_bucket():
    def run(scheduler):
        svc = OptimizationService(device="cpu", scheduler=scheduler)
        hs = [svc.submit(zdt1, {f"x{i}": [0.0, 1.0] for i in range(4)}, ["f1", "f2"],
                         opt_id=f"a{k}", n_epochs=2, population_size=16,
                         num_generations=4, n_initial=3, optimizer_name="age",
                         surrogate_method_kwargs={"n_starts": 2, "n_iter": 10, "seed": 0},
                         random_seed=30 + k) for k in range(2)]
        svc.run()
        routes = svc.telemetry.registry.snapshot()
        out = [[(u.epoch, u.x, u.y) for u in h.updates()] for h in hs]
        svc.close()
        return out, routes

    lock, snap = run(None)
    graph, _ = run(2)
    counters = snap["counters"]
    # two tenants, two epochs, one bucket each
    assert counters["tenants_batched_total"] == {"": 4.0}
    assert counters["tenant_bucket_epochs_total"] == {"bucket=d4_o2_p16": 2.0}
    for a, b in zip(lock, graph):
        assert [e for e, _, _ in a] == [e for e, _, _ in b]
        for (_, xa, ya), (_, xb, yb) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
