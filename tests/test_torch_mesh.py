"""The port's multi-device layer (`parallel.mesh`, `parallel.loopback`,
the sharded evaluator, predict and fit, ``run(mesh=...)``) on the CPU.

World size 1, in this process (a gloo group over an in-process store):
`create_mesh` and the layouts of `shard_population` and `shard_state`,
the sharded rank bitwise equal to the JAX package's single-device
`non_dominated_rank` (masks, repeated rows, NaN), and ``run(mesh=...)``
equal to ``run()`` bitwise.

More than one rank: one module-scoped fixture starts a two-process gloo
cluster once, through `parallel.loopback`, running
`dmosopt_tpu_torch.testing.multihost`'s ``checks`` in both ranks, and
the tests read what each rank wrote. The JAX package's own sharded
functions are pinned to its single-device ones (tests/test_parallel.py,
tests/test_gp_sharded.py, tests/test_multihost.py); JAX with virtual
devices cannot start inside a test worker, so the port's sharded
results are held against the single-device functions:

- the sharded rank at d = 2 and d = 3, and on both layouts of a
  ("pop", "model") mesh, bitwise equal to the JAX package's tiled rank;
- the sharded batch evaluator equal to ZDT1 on the whole batch (13
  rows, no multiple of the axis), and to the JAX package's ZDT1 within
  rtol 1e-6;
- one NSGA-II generation under the sharded rank bitwise equal to the
  replicated one;
- the ``"model"``-axis restart split of `fit_gp_batch` within rtol 2e-3
  of the unsplit fit (predictions rtol 1e-3 / atol 1e-4, variance rtol
  2e-3), tests/test_parallel.py's tolerances;
- the ``query_sharding`` predict within atol 1e-5 of the unsharded
  matmul predict (variance rtol 5e-3);
- the sharded posterior at two ranks as close to a float64 dense
  oracle as the float32 dense one (L atol 2e-5, alpha and W 2e-4 of
  their scales, the NMLL rtol 1e-4), and the sharded fit within
  tests/test_gp_sharded.py's tolerances of `fit_gp_batch`;
- ``run(mesh=...)`` across the two processes bitwise equal to the
  single-process ``run()``, and a resumed run in which both ranks take
  the resume branch, the store grows and the two ranks' archives agree.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax.numpy as jnp
import torch

# one intra-op thread: the test workers share the machine, and torch's
# default of one thread per core oversubscribes it
torch.set_num_threads(1)

from dmosopt_tpu.benchmarks.zdt import zdt1 as jax_zdt1
from dmosopt_tpu.ops.dominance import _rank_matrix_peel, non_dominated_rank as jax_rank
import dmosopt_tpu_torch
from dmosopt_tpu_torch.benchmarks.zdt import zdt1
from dmosopt_tpu_torch.models import gp
from dmosopt_tpu_torch.models.predictor import GPPredictor, build_whitened_cache
from dmosopt_tpu_torch.ops.dominance import non_dominated_rank
from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2State
from dmosopt_tpu_torch.parallel import loopback, mesh as M
from dmosopt_tpu_torch.testing import multihost as MH


@pytest.fixture(scope="module")
def group():
    with MH.local_group():
        yield M.create_mesh(device="cpu")


# ------------------------------------------------------------ world size 1


def test_entry_points_default_to_cuda(group, monkeypatch):
    # device=None means this rank's CUDA device (an NCCL group), and raises
    # without a card rather than building a gloo group on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.initialize_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.create_mesh()
    assert M._backend_for("cuda") == "nccl" and M._backend_for("cpu") == "gloo"
    # in a cluster of cards, rank r takes card r % device_count as current
    current = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    assert M._local_cuda_device(5) == torch.device("cuda", 1)
    assert current == [torch.device("cuda", 1)]


def test_create_mesh_and_layouts(group):
    mesh = group
    assert mesh.mesh_dim_names == ("pop",) and M.axis_size(mesh, "pop") == 1
    assert M.is_primary_process() and M.process_count() == 1
    two = M.create_mesh(axis_names=("pop", "model"), device="cpu")
    assert two.mesh_dim_names == ("pop", "model") and two.mesh.shape == (1, 1)
    with pytest.raises(ValueError, match="every rank"):
        M.create_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="lay out"):
        M.create_mesh(axis_names=("pop", "model"), shape=(1,), device="cpu")
    x = torch.arange(40.0).reshape(10, 4)
    assert torch.equal(M.shard_population(x, mesh), x)
    assert [M.row_block(10, 4, i) for i in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    state = NSGA2State(*(torch.arange(10.0) for _ in NSGA2State.field_names()))
    for f in NSGA2State.field_names():
        assert torch.equal(getattr(M.shard_state(state, 10, mesh), f), getattr(state, f))
    assert M.population_sharding(mesh) == M.Sharding(mesh, "pop")
    assert M.replicate(mesh).axis is None


@pytest.mark.parametrize("d", [2, 3, 5])
def test_world1_sharded_rank_matches_jax(group, d):
    # the cluster's shapes, so the JAX programs compile once for both
    Y, m = MH.rank_inputs(d + 20, 203, d)
    want = np.asarray(jax_rank(jnp.asarray(Y), mask=jnp.asarray(m), tile=32))
    got = M.non_dominated_rank_sharded(torch.as_tensor(Y), group,
                                       mask=torch.as_tensor(m), tile=32).numpy()
    np.testing.assert_array_equal(got, want)


def test_world1_run_with_mesh_equals_run(group):
    dmosopt_tpu_torch.run(MH.run_params("w1_plain"), verbose=False)
    dmosopt_tpu_torch.run(MH.run_params("w1_mesh", mesh=group), verbose=False)
    for a, b in zip(MH.archive("w1_plain"), MH.archive("w1_mesh")):
        np.testing.assert_array_equal(a, b)


def test_train_forwards_mesh_to_gp(group):
    """`moasmo.train` hands a mesh to a surrogate whose constructor names
    it (tests/test_parallel.py:233), which fits and predicts soundly."""
    from dmosopt_tpu_torch import moasmo
    from dmosopt_tpu_torch.models.gp import EGP_Matern, GPR_Matern

    rng = np.random.default_rng(2)
    X = rng.random((40, 3))
    Y = np.stack([X[:, 0], X.sum(1)], 1)
    two = M.create_mesh(axis_names=("pop", "model"), device="cpu")
    for name, cls in (("gpr", GPR_Matern), ("egp", EGP_Matern)):
        m = moasmo.train(3, 2, np.zeros(3), np.ones(3), X, Y, None,
                         surrogate_method_name=name,
                         surrogate_method_kwargs={"n_starts": 2, "n_iter": 10, "seed": 0},
                         mesh=two, device="cpu")
        assert isinstance(m, cls) and m._mesh is two
        mu, var = m.predict(X[:5])
        assert bool(torch.isfinite(mu).all()) and bool((var > 0).all())


def test_population_the_axis_does_not_divide_runs_replicated():
    from types import SimpleNamespace

    from dmosopt_tpu_torch.moasmo import _shard_if_divisible

    class TwoRanks:
        mesh_dim_names = ("pop",)
        n = 2

        def size(self, dim):
            return self.n

    class OneRank(TwoRanks):
        n = 1

    assert _shard_if_divisible(SimpleNamespace(capacity=16, popsize=16), None) is None
    # one device splits nothing: the blocked single-device rank runs
    assert _shard_if_divisible(SimpleNamespace(capacity=16, popsize=16), OneRank()) is None
    assert _shard_if_divisible(SimpleNamespace(capacity=16, popsize=16), TwoRanks()) is not None
    with pytest.warns(UserWarning, match="not divisible by mesh axis 'pop' size 2"):
        assert _shard_if_divisible(SimpleNamespace(capacity=15, popsize=15), TwoRanks()) is None


# --------------------------------------------------------- two processes


@pytest.fixture(scope="module", autouse=True)
def _cluster_started(tmp_path_factory):
    """The store a single process writes, then the two-process cluster,
    started before this module's first test and running beside the
    in-process ones."""
    import h5py

    out = tmp_path_factory.mktemp("cluster")
    store = str(out / "store.h5")
    dmosopt_tpu_torch.run(MH.run_params("mh_resume", save=True, file_path=store),
                          verbose=False)
    with h5py.File(store, "r") as f:
        before = (f["mh_resume/0/parameters"].shape[0],
                  int(np.asarray(f["mh_resume/0/epochs"]).max()))
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(loopback.launch_loopback_cluster, MH.__file__,
                           n_processes=2, timeout=300, extra_args=("checks", str(out)))
        yield done, out, store, before


@pytest.fixture(scope="module")
def cluster(_cluster_started):
    """Both ranks' outputs of the ``checks`` task, and the store's row
    and epoch counts before the cluster resumed it."""
    done, out, store, before = _cluster_started
    results = done.result()
    for rc, text in results:
        assert rc == 0 and "MULTIHOST_OK" in text, text[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    records = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    return ranks, records, store, before


def test_cluster_sharded_rank_bitwise(cluster):
    ranks = cluster[0]
    for d in (2, 3):
        Y, m = MH.rank_inputs(d, 203, d)
        want = np.asarray(jax_rank(jnp.asarray(Y), mask=jnp.asarray(m), tile=32))
        np.testing.assert_array_equal(
            non_dominated_rank(torch.as_tensor(Y), mask=torch.as_tensor(m)).numpy(), want)
        for r in ranks:
            np.testing.assert_array_equal(r[f"rank_d{d}"], want)
    Y, _ = MH.rank_inputs(9, 157, 5)
    want = np.asarray(_rank_matrix_peel(jnp.asarray(Y)))
    for r in ranks:
        for key in ("rank_2axis_21", "rank_2axis_12"):
            np.testing.assert_array_equal(r[key], want, err_msg=key)


def test_cluster_evaluator_and_nsga2_step(cluster):
    rows = np.random.default_rng(0).random((13, 6)).astype(np.float32)
    want = zdt1(torch.as_tensor(rows)).numpy()
    step = MH.nsga2_step()
    for r in cluster[0]:
        np.testing.assert_array_equal(r["evaluator"], want)
        np.testing.assert_allclose(r["evaluator"], np.asarray(jax_zdt1(jnp.asarray(rows))),
                                   rtol=1e-6)
        np.testing.assert_array_equal(r["nsga2_step"], step)


def test_cluster_model_axis_split_and_query_sharding(cluster):
    X, Yg = MH.gp_data(48)
    Xq = torch.as_tensor(np.random.default_rng(3).random((64, 4)).astype(np.float32))
    plain = gp.fit_gp_batch(torch.Generator().manual_seed(1), torch.as_tensor(X),
                            torch.as_tensor(Yg), n_starts=4, n_iter=30)
    mu, var = (t.numpy() for t in gp.gp_predict(plain, Xq))
    fit = gp.fit_gp_batch(torch.Generator().manual_seed(2), torch.as_tensor(X),
                          torch.as_tensor(Yg), n_starts=2, n_iter=20)
    qm, qv = (t.numpy() for t in GPPredictor(fit, "matern52", mode="matmul")
              .predict_normalized(Xq))
    for r in cluster[0]:
        np.testing.assert_allclose(r["model_split_amp"], plain.amp.numpy(), rtol=2e-3)
        np.testing.assert_allclose(r["model_split_ls"], plain.ls.numpy(), rtol=2e-3)
        np.testing.assert_allclose(r["model_split_mean"], mu, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(r["model_split_var"], var, rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(r["query_mean"], qm, atol=1e-5)
        np.testing.assert_allclose(r["query_var"], qv, rtol=5e-3, atol=1e-5)


def _posterior_bars(L, alpha, nmll, W, oracle):
    """A float32 posterior against the float64 dense oracle: L within
    atol 2e-5, alpha and W within 2e-4 of their largest entries, the
    NMLL rtol 1e-4 (atol 1e-3)."""
    L0, a0, n0, W0 = (t.numpy() for t in oracle)
    np.testing.assert_allclose(L, L0, atol=2e-5)
    np.testing.assert_allclose(alpha, a0, atol=2e-4 * np.abs(a0).max())
    np.testing.assert_allclose(nmll, n0, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(W, W0, atol=2e-4 * np.abs(W0).max())


def _dense_posterior(X, Y, tm, amp, ls, noise):
    L, a, n = gp.posterior_from_params(X, Y * tm[:, None], tm, amp, ls, noise,
                                       "matern52", 1e-4)
    W = build_whitened_cache(gp.GPFit(X=X, L=L, alpha=a, amp=amp, ls=ls, noise=noise,
                                      y_mean=None, y_std=None, nmll=n, train_mask=tm))
    return L, a, n, W


def test_cluster_sharded_posterior_and_fit(cluster):
    Xs, Ys = (torch.as_tensor(a) for a in MH.gp_data(64, seed=4))
    tm = torch.as_tensor((np.arange(64) < 56).astype(np.float32))
    amp, ls, noise = torch.tensor([1.3, 0.8]), torch.tensor([[0.4], [0.7]]), torch.tensor([1e-4, 3e-4])
    oracle = _dense_posterior(*(t.double() for t in (Xs, Ys, tm, amp, ls, noise)))
    # the dense float32 posterior meets the same bars
    _posterior_bars(*(t.numpy() for t in _dense_posterior(Xs, Ys, tm, amp, ls, noise)),
                    oracle)
    ref = gp.fit_gp_batch(torch.Generator().manual_seed(2), Xs, Ys, train_mask=tm,
                          n_starts=2, n_iter=8)
    Xq = torch.as_tensor(np.random.default_rng(3).random((64, 4)).astype(np.float32))
    for r in cluster[0]:
        _posterior_bars(r["post_L"], r["post_alpha"], r["post_nmll"], r["post_W"], oracle)
        np.testing.assert_allclose(r["fit_nmll"], ref.nmll.numpy(), rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(np.log(r["fit_ls"]), np.log(ref.ls.numpy()), atol=0.15)
        np.testing.assert_allclose(r["fit_mean"], gp.gp_predict(ref, Xq)[0].numpy(),
                                   atol=2e-2)


def test_cluster_run_equals_single_process_run(cluster):
    best = dmosopt_tpu_torch.run(MH.run_params("mh_single"), verbose=False)
    y = np.column_stack([v for _, v in best[1]])
    x_all, y_all = MH.archive("mh_single")
    for r in cluster[0]:
        np.testing.assert_array_equal(r["run_best_y"], y)
        np.testing.assert_array_equal(r["run_x"], x_all)
        np.testing.assert_array_equal(r["run_y"], y_all)


def test_cluster_resume_takes_one_branch(cluster):
    import h5py

    ranks, records, store, (n_before, e_before) = cluster
    assert records[0] == records[1]
    # the run resumes after the stored epochs
    assert records[0]["resuming"] and records[0]["start_epoch"] == e_before + 1
    with h5py.File(store, "r") as f:
        n_after = f["mh_resume/0/parameters"].shape[0]
        e_after = int(np.asarray(f["mh_resume/0/epochs"]).max())
    assert n_after > n_before and e_after > e_before
    for key in ("resume_x", "resume_y"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    # the primary's store holds the archive both ranks ended with
    assert n_after == ranks[0]["resume_x"].shape[0]
