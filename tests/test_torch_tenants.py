"""The port's problem-batched tenant core against the JAX package and
against the port's own sequential path.

- The batched offspring step (`_offspring_core` with a leading tenants
  axis, what a CPU tensor runs and what the bucket launch of the fused
  Triton kernel is held to on the card) against the JAX generation
  vmapped over tenants, with the Pallas kernels in interpret mode as
  tests/test_torch_offspring.py runs them: rtol 1e-6 / atol 1e-7, the
  operator tags exactly equal; per-tenant rates and per-gene indices
  differ between tenants.
- `fit_gp_problems` / `gp_predict_problems`, at tests/test_torch_gp.py's
  tolerances: single-restart fits (RNG-free, 60 fixed steps) land on the
  JAX package's hyperparameters within rtol 1e-3 (a noise floor of
  1e-4); predictions from those JAX fits carried over (with that test's
  output moments) agree within rtol 1e-4 (atol 1e-5) on the mean and
  within 1e-4 of the prior variance (amp·y_std²) on the variance; the
  stacked predict equals each
  problem's own `gp_predict`; and a
  multi-restart bucket fit equals each problem's standalone fit from the
  same seed (rtol 1e-5).
- One NSGA-II generation on stacked states with the JAX draws injected:
  the mating pools (Gumbel top-k over each tenant's rank order) and the
  stacked survival's ranks and survivors exactly equal on tie-free
  inputs.
- `run_bucket_epoch` for 2 tenants against the port's sequential
  `initialize_epoch`, tenant by tenant: fit hyperparameters to 1e-5, the
  EA's final population to 1e-5 with ranks exactly equal, the resample
  rows equal.
- Eligibility reasons against ``dmosopt_tpu.tenants.batch_eligibility``
  (AGE-MOEA included), and a bucket whose offspring step
  raises raising out of `run()` with no sequential re-run.

Every JAX reference is one ``jax.jit`` program, compiled once in a
module-scoped fixture.
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu import tenants as JT
from dmosopt_tpu.models import gp as JGP
from dmosopt_tpu.ops import variation as JV
from dmosopt_tpu.optimizers.nsga2 import NSGA2 as JNSGA2
import dmosopt_tpu_torch
from dmosopt_tpu_torch import interop, tenants
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.driver import dopt_init
from dmosopt_tpu_torch.models import gp as TGP
from dmosopt_tpu_torch.ops import variation as TV
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2

F32 = np.float32
T, POP, POOL, N = 3, 16, 8, 4


# ------------------------------------------------- batched offspring step


def _bucket_inputs(seed=0):
    rng = np.random.default_rng(seed)
    npairs = POP // 2
    xlb = (-1.0 + 0.5 * rng.random((T, N))).astype(F32)
    xub = (1.0 + rng.random((T, N))).astype(F32)
    return {
        "parm": (xlb[:, None] + (xub - xlb)[:, None] * rng.random((T, POP, N))).astype(F32),
        "pool_idx": np.stack([rng.permutation(POP)[:POOL] for _ in range(T)]).astype(np.int64),
        "r": rng.random((T, 3, npairs), dtype=F32),
        "u": rng.random((T, 3, npairs, N), dtype=F32),
        "pc": np.asarray([0.9, 0.6, 0.75], F32), "pm": np.asarray([0.1, 0.4, 0.2], F32),
        "rate": np.asarray([1.0 / N, 0.5, 0.3], F32),
        "di_c": (1.0 + 4.0 * rng.random((T, N))).astype(F32),
        "di_m": (15.0 + 10.0 * rng.random((T, N))).astype(F32),
        "xlb": xlb, "xub": xub,
    }


def _jax_generation(parm, pool_idx, r, u, pc, pm, rate, di_c, di_m, xlb, xub):
    """One tenant's offspring as the JAX generation computes them
    (``dmosopt_tpu/optimizers/nsga2.py:176-192``) from injected indices
    and uniforms, with the Pallas kernels."""
    i1 = (r[0] * F32(POOL)).astype(jnp.int32)
    i2 = (i1 + 1 + (r[1] * F32(POOL - 1)).astype(jnp.int32)) % POOL
    p1, p2 = parm[pool_idx[i1]], parm[pool_idx[i2]]
    c1, c2 = JV._sbx_pallas(u[0], p1, p2, di_c, xlb, xub)
    m1 = JV._mutation_pallas(u[1], p1, di_m, xlb, xub, rate)
    m2 = JV._mutation_pallas(u[2], p2, di_m, xlb, xub, rate)
    is_x = r[2] < (2.0 * pc) / (2.0 * pc + pm)
    o1 = jnp.where(is_x[:, None], c1, m1)
    o2 = jnp.where(is_x[:, None], c2, m2)
    return jnp.concatenate([o1, o2], axis=0), is_x


@pytest.fixture(scope="module")
def jax_bucket():
    a = _bucket_inputs()
    keys = ("parm", "pool_idx", "r", "u", "pc", "pm", "rate", "di_c", "di_m", "xlb", "xub")
    out, is_x = jax.jit(jax.vmap(_jax_generation))(*(jnp.asarray(a[k]) for k in keys))
    return a, np.asarray(out), np.asarray(is_x)


def test_batched_offspring_matches_vmapped_jax_generation(jax_bucket):
    a, want, want_x = jax_bucket
    t = torch.as_tensor
    pool_n = torch.full((T,), POOL, dtype=torch.int32)
    # the bounds as the stacked state passes them: strided columns of (T, n, 2)
    bounds = t(np.stack([a["xlb"], a["xub"]], axis=2))
    before = dict(TV.KERNEL_LAUNCHES)
    got, got_x = TV.offspring(
        t(a["parm"]), t(a["pool_idx"]), t(a["r"]), t(a["u"]), pool_n, pool_n,
        t(a["pc"]), t(a["pm"]), t(a["rate"]), t(a["di_c"]), t(a["di_m"]),
        bounds[..., 0], bounds[..., 1],
    )
    assert TV.KERNEL_LAUNCHES == before  # a CPU tensor takes the plain core
    assert got.shape == (T, POP, N) and got_x.shape == (T, POP // 2)
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    assert 0 < int(got_x.sum()) < T * (POP // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # each tenant's slice is the single-population step on its operands
    for i in range(T):
        one, one_x = TV.offspring(
            t(a["parm"][i]), t(a["pool_idx"][i]), t(a["r"][i]), t(a["u"][i]),
            torch.tensor(POOL, dtype=torch.int32), torch.tensor(POOL, dtype=torch.int32),
            t(a["pc"][i]), t(a["pm"][i]), t(a["rate"][i]), t(a["di_c"][i]),
            t(a["di_m"][i]), t(a["xlb"][i]), t(a["xub"][i]),
        )
        assert torch.equal(one, got[i]) and torch.equal(one_x, got_x[i])


# ------------------------------------------------------- problems-axis fit


def _problems_data(P=3, N_rows=40, n=3, seed=0):
    """Each problem's rows as tests/test_torch_gp.py makes them (a target
    rough enough that amplitude and lengthscale are well determined),
    from its own seed, bucket-padded."""
    padded = []
    for p in range(P):
        rng = np.random.default_rng(seed + p)
        X = rng.random((N_rows, n)).astype(F32)
        Y = np.stack([np.sin(6 * X[:, 0]) + np.cos(5 * X[:, 1]) * X[:, 2],
                      np.cos(7 * X[:, 2]) - np.sin(4 * X[:, 0])], axis=1)
        padded.append(TGP._pad_to_bucket(X, ((Y - Y.mean(0)) / Y.std(0)).astype(F32)))
    return tuple(np.stack([pp[k] for pp in padded]).astype(F32) for k in range(3))


# a noise floor of 1e-4 keeps the three single-restart fits' 60 float32
# steps on the well-determined part of the NMLL, as tests/test_torch_gp.py's
# one data set does at the default floor
NOISE = (1e-4, 1e-2)


@pytest.fixture(scope="module")
def jax_problem_fits():
    X, Y, M = _problems_data()
    keys = jax.random.split(jax.random.PRNGKey(4), X.shape[0])

    fit = jax.jit(partial(JGP.fit_gp_problems, n_starts=1, n_iter=60,
                          convergence_tol=None, noise_bounds=NOISE))
    jsingle = fit(keys, *(jnp.asarray(a) for a in (X, Y, M)))
    # the carried fit: the same, with tests/test_torch_gp.py's carried-fit
    # moments in every problem
    jfit = jsingle._replace(y_mean=jnp.tile(jnp.asarray([0.5, -1.0]), (3, 1)),
                         y_std=jnp.tile(jnp.asarray([2.0, 0.5]), (3, 1)))
    Xq = np.random.default_rng(5).random((3, 17, 3)).astype(F32)
    pred = jax.jit(JGP.gp_predict_problems)(jfit, jnp.asarray(Xq))
    return (X, Y, M), jsingle, jfit, Xq, tuple(np.asarray(p) for p in pred)


def test_single_restart_problem_fits_match_jax(jax_problem_fits):
    (X, Y, M), jsingle, *_ = jax_problem_fits
    gens = [torch.Generator().manual_seed(p) for p in range(3)]
    fit = TGP.fit_gp_problems(gens, torch.as_tensor(X), torch.as_tensor(Y),
                              torch.as_tensor(M), n_starts=1, n_iter=60,
                              convergence_tol=None, noise_bounds=NOISE)
    assert fit.n_steps == 60 and fit.amp.shape == (3, 2) and fit.L.shape[:2] == (3, 2)
    for name in ("amp", "ls", "noise"):
        np.testing.assert_allclose(getattr(fit, name).numpy(),
                                   np.asarray(getattr(jsingle, name)), rtol=1e-3,
                                   err_msg=name)


def test_predict_problems_on_a_carried_jax_fit(jax_problem_fits):
    _, _, jfit, Xq, (want_m, want_v) = jax_problem_fits
    tfit = interop.gp_fit_from_arrays(
        {k: (None if v is None else np.asarray(v)) for k, v in jfit._asdict().items()},
        "cpu",
    )
    got_m, got_v = TGP.gp_predict_problems(tfit, torch.as_tensor(Xq))
    assert got_m.shape == (3, 17, 2)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-4, atol=1e-5)
    # the float32 variance amp + noise - |v|^2 cancels at the prior
    # variance's scale: its rtol 1e-4 is taken of that scale, per problem
    # and objective (an absolute 1e-6 holds for test_torch_gp.py's one fit)
    prior = (tfit.amp * tfit.y_std**2).numpy()[:, None, :]
    diff = np.abs(got_v.numpy() - want_v)
    np.testing.assert_array_less(diff, np.broadcast_to(1e-4 * prior, diff.shape))
    for p in range(3):
        one = TGP.GPFit(**{f: getattr(tfit, f)[p] for f in (
            "X", "L", "alpha", "amp", "ls", "noise", "y_mean", "y_std", "nmll",
            "train_mask")})
        m, v = TGP.gp_predict(one, torch.as_tensor(Xq[p]))
        np.testing.assert_allclose(got_m[p].numpy(), m.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_v[p].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


def test_problem_fit_equals_each_standalone_fit():
    """Each problem's restarts come from its own generator, drawn as its
    standalone fit draws them; with a fixed step count (no bucket-wide
    convergence stop) the bucket fit is each standalone fit."""
    X, Y, M = (torch.as_tensor(a) for a in _problems_data(seed=1))
    cfg = dict(n_starts=3, n_iter=30, convergence_tol=None)
    fit = TGP.fit_gp_problems([torch.Generator().manual_seed(7 + p) for p in range(3)],
                              X, Y, M, **cfg)
    for p in range(3):
        one = TGP.fit_gp_batch(torch.Generator().manual_seed(7 + p), X[p], Y[p],
                               train_mask=M[p], **cfg)
        for name in ("amp", "ls", "noise", "nmll", "alpha"):
            np.testing.assert_allclose(getattr(fit, name)[p].numpy(),
                                       getattr(one, name).numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


# ------------------------------------------ stacked NSGA-II generation


@pytest.fixture(scope="module")
def jax_stacked_generation():
    rng = np.random.default_rng(11)
    pop, n, d = 20, 5, 2
    x0 = rng.random((T, 30, n)).astype(F32)
    y0 = rng.random((T, 30, d)).astype(F32)
    bounds = np.broadcast_to(np.stack([np.zeros(n), np.ones(n)], 1), (T, n, 2)).astype(F32)
    x_gen = rng.random((T, pop, n)).astype(F32)
    y_gen = rng.random((T, pop, d)).astype(F32)
    jopt = JNSGA2(popsize=pop, nInput=n, nOutput=d, model=None)

    @jax.jit
    @jax.vmap
    def generation(k, x, y, b, xg, yg):
        state = jopt.initialize_state(k, x, y, b)
        pool = JV.tournament_selection(k, pop // 2, state.rank)
        gumbel = jax.random.gumbel(k, (pop,), jnp.float32)
        return state, pool, gumbel, jopt.update_strategy(state, xg, yg)

    keys = jax.random.split(jax.random.PRNGKey(3), T)
    states, pools, gumbel, new = generation(
        keys, *(jnp.asarray(a) for a in (x0, y0, bounds, x_gen, y_gen)))
    to_np = lambda s: {k: np.asarray(v) for k, v in s._asdict().items()}  # noqa: E731
    return (x0, y0, bounds, x_gen, y_gen, to_np(states), np.asarray(pools),
            np.asarray(gumbel), to_np(new))


def test_stacked_generation_matches_vmapped_jax(jax_stacked_generation):
    x0, y0, bounds, x_gen, y_gen, jstates, jpools, gumbel, jnew = jax_stacked_generation
    t = torch.as_tensor
    opt = NSGA2(popsize=20, nInput=5, nOutput=2, model=None, device="cpu")
    # the stacked initialization sorts each tenant's rows as JAX's vmap does
    states = opt.initialize_state(None, t(x0), t(y0), t(bounds))
    for name in ("population_parm", "population_obj", "rank"):
        np.testing.assert_array_equal(getattr(states, name).numpy(), jstates[name], name)
    assert states.crossover_prob.shape == (T,) and states.di_mutation.shape == (T, 5)
    # the mating pools: each tenant's Gumbel top-k over its rank order
    order, prob = TV._tournament_order(states.rank)
    pools = TV._gumbel_top_k(order, prob, torch.tensor(gumbel), 10)
    np.testing.assert_array_equal(pools.numpy(), jpools)
    # the survival of a carried stacked state
    carried = interop.stacked_nsga2_state_from_arrays(jstates, "cpu")
    new = opt.update_strategy(carried, t(x_gen), t(y_gen))
    for name in ("population_parm", "population_obj", "rank"):
        np.testing.assert_array_equal(getattr(new, name).numpy(), jnew[name], name)
    # generate on stacked states: one draw stream a tenant, T tenants' offspring
    gens = [torch.Generator().manual_seed(s) for s in range(T)]
    x_new, state = opt.generate_strategy(gens, new)
    assert x_new.shape == (T, 20, 5) and state.last_is_crossover.shape == (T, 20)
    for i in range(T):
        one = interop.nsga2_state_from_arrays({k: v[i] for k, v in jnew.items()}, "cpu")
        x_one, _ = opt.generate_strategy(torch.Generator().manual_seed(i), one)
        assert torch.equal(x_one, x_new[i])


# ------------------------------------------- bucket epoch vs sequential


def _params(opt_id, **over):
    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(4)}, "problem_parameters": {},
        "n_initial": 3, "n_epochs": 2, "population_size": 16, "num_generations": 8,
        "resample_fraction": 0.5, "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 40, "seed": 0},
        "random_seed": 17, "problem_ids": {0, 1}, "device": "cpu",
    }
    params.update(over)
    return params


def _opened(opt_id):
    """Two tenants with their initial designs evaluated."""
    dopt = dopt_init(_params(opt_id), initialize_strategy=True)
    dopt._process_requests()
    return dopt


def test_bucket_epoch_matches_sequential_tenant_by_tenant(monkeypatch):
    seq, bat = _opened("tenants_seq"), _opened("tenants_bat")
    routing = tenants.initialize_epochs_batched(seq.optimizer_dict, 0, min_bucket=3)
    assert routing == {0: "sequential", 1: "sequential"}
    fits = []

    def spy(*a, **k):
        fits.append(orig(*a, **k))
        return fits[-1]

    orig = tenants.fit_gp_problems
    monkeypatch.setattr(tenants, "fit_gp_problems", spy)
    routing = tenants.initialize_epochs_batched(bat.optimizer_dict, 0)
    assert routing == {0: "batched", 1: "batched"}
    for pid in (0, 1):
        res_s, res_b = seq.optimizer_dict[pid].opt_gen, bat.optimizer_dict[pid].opt_gen
        fit_s = res_s["optimizer"].model.objective.fit
        for name in ("amp", "ls", "noise"):
            np.testing.assert_allclose(getattr(fits[0], name)[pid].numpy(),
                                       getattr(fit_s, name).numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        st_s, st_b = res_s["optimizer"].state, res_b["optimizer"].state
        np.testing.assert_array_equal(st_b.rank.numpy(), st_s.rank.numpy())
        np.testing.assert_allclose(st_b.population_parm.numpy(),
                                   st_s.population_parm.numpy(), atol=1e-5)
        np.testing.assert_array_equal(res_b["x_resample"], res_s["x_resample"])
        np.testing.assert_array_equal(res_b["gen_index"], res_s["gen_index"])
        assert res_b["stats"]["n_generations"] == 8


def _namespace(**over):
    base = dict(
        x=np.zeros((10, 4)), optimizer_name=("nsga2",), surrogate_method_name="gpr",
        surrogate_custom_training=None, sensitivity_method_name=None,
        feasibility_method_name=None, optimize_mean_variance=False, termination=None,
        refit_controller=None, mesh=None, distance_metric=None, num_generations=8,
        surrogate_method_kwargs={"n_starts": 2}, optimizer_kwargs=({},),
    )
    base.update(over)
    return SimpleNamespace(**base)


CONFIGS = [
    {}, {"x": None}, {"optimizer_name": ("nsga2", "age")}, {"optimizer_name": ("cmaes",)},
    {"surrogate_method_name": "svgp"}, {"surrogate_custom_training": "m.f"},
    {"sensitivity_method_name": "fast"}, {"feasibility_method_name": "logreg"},
    {"optimize_mean_variance": True}, {"termination": object()},
    {"refit_controller": object()}, {"distance_metric": "euclidean"},
    {"num_generations": 0}, {"surrogate_method_kwargs": {"bogus": 1}},
    {"surrogate_method_kwargs": {"predictor": "matmul"}},
    {"surrogate_method_kwargs": {"dtype": "float64"}},
    {"optimizer_kwargs": ({"adaptive_population_size": True},)},
    {"optimizer_kwargs": ({"distance_metric": "crowding"},)},
    {"x": np.zeros((5000, 4))}, {"x": np.zeros((20, 4)),
                                 "surrogate_method_kwargs": {"large_n_threshold": 16}},
]


def test_eligibility_reasons_match_jax():
    for over in CONFIGS:
        strat = _namespace(**over)
        assert tenants.batch_eligibility(strat) == JT.batch_eligibility(strat), over
    # AGE-MOEA tenants join buckets in both packages
    age = _namespace(optimizer_name=("age",))
    assert JT.batch_eligibility(age) is None
    assert tenants.batch_eligibility(age) is None
    assert tenants.bucket_signature(_namespace(prob=SimpleNamespace(dim=4, n_objectives=2),
                                               population_size=16), "nsga2", {}) \
        == JT.bucket_signature(_namespace(prob=SimpleNamespace(dim=4, n_objectives=2),
                                          population_size=16), "nsga2", {})


def test_a_failing_bucket_raises_and_never_runs_sequentially(monkeypatch):
    def broken(parm, *a):
        if parm.dim() == 3:
            raise RuntimeError("bucket offspring step failed")
        return orig(parm, *a)

    orig = TV._offspring_core
    monkeypatch.setattr(TV, "_offspring_core", broken)
    sequential = []
    monkeypatch.setattr(
        dmosopt_tpu_torch.strategy.DistOptStrategy, "initialize_epoch",
        lambda self, e: sequential.append(e),
    )
    with pytest.raises(RuntimeError, match="bucket offspring step failed"):
        dmosopt_tpu_torch.run(_params("tenants_broken", tenant_batching=True),
                              verbose=False)
    assert sequential == []
    # with on_error the bucket's tenants are reported failed, not re-run
    dopt = _opened("tenants_isolated")
    errors = []
    routing = tenants.initialize_epochs_batched(
        dopt.optimizer_dict, 0, on_error=lambda pid, e: errors.append(pid))
    assert routing == {0: "failed", 1: "failed"} and errors == [0, 1]
    assert sequential == []
