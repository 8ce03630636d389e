"""The rank program of a loopback cluster: the port's mesh code across
processes.

Launched by `parallel.loopback.launch_loopback_cluster` as
``python dmosopt_tpu_torch/testing/multihost.py <coordinator> <n> <rank>
<task> [args...]`` in every rank (the counterpart of the JAX package's
``tests/_multihost_worker.py`` and ``_multihost_run_worker.py``). Tasks:

- ``checks <out_dir>`` (CPU ranks on gloo): the sharded rank at d = 2
  and d = 3 on a 1-axis mesh and on both layouts of a 2-axis mesh, the
  sharded batch evaluator, one NSGA-II generation under the sharded
  rank, the ``"model"``-axis restart split of `fit_gp_batch`, the
  ``query_sharding`` predict, the sharded GP posterior and fit, a
  ``run(mesh=...)``, and a resumed ``run(mesh=...)`` of the store in
  ``out_dir``; each rank writes its outputs to ``out_dir/rank<r>.npz``
  and its resume record to ``out_dir/rank<r>.json``, which the tests
  hold against single-process references.
- ``chip <json_path>`` (CUDA ranks sharing one card over gloo): the
  sharded rank of 16 384 rows x 3 objectives against the single-device
  rank, and the sharded fit at 2048 rows against `fit_gp_batch`; rank 0
  writes the comparison to ``json_path``.

Every rank prints ``MULTIHOST_OK`` when its task passed. The input
builders are shared with the tests, which rebuild the same data;
`local_group` gives a test process a one-process group of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch


@contextlib.contextmanager
def local_group():
    """A one-process gloo group of this process's own for the duration
    (an in-process store), unless one is already initialized."""
    import torch.distributed as dist

    from dmosopt_tpu_torch.parallel.mesh import initialize_distributed

    owned = not dist.is_initialized()
    if owned:
        initialize_distributed(device="cpu")
    try:
        yield
    finally:
        if owned:
            dist.destroy_process_group()


def rank_inputs(seed: int, n: int, d: int):
    """(Y, mask) of a rank check: uniform rows with repeated rows, a few
    NaN, a third masked."""
    rng = np.random.default_rng(seed)
    Y = rng.random((n, d)).astype(np.float32)
    Y[rng.integers(0, n, 5)] = Y[rng.integers(0, n, 5)]
    Y[rng.integers(0, n, 3), 0] = np.nan
    return Y, rng.random(n) > 0.3


def gp_data(P: int, dim: int = 4, seed: int = 0):
    """(X (P, dim), Y (P, 2)) float32 of a GP check, standardized."""
    rng = np.random.default_rng(seed)
    X = rng.random((P, dim)).astype(np.float32)
    Y = np.stack([np.sin(2.0 * X[:, 0]), X.sum(1)], 1)
    return X, ((Y - Y.mean(0)) / Y.std(0)).astype(np.float32)


def run_params(opt_id: str, **over):
    """A small ZDT1 run of a torch objective on the CPU (pop 16, divisible
    by the mesh axis), with the matmul predictor so its predicts split
    their queries under a mesh."""
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1

    params = {
        "opt_id": opt_id, "obj_fun": zdt1, "torch_objective": True,
        "objective_names": ["f1", "f2"],
        "space": {f"x{i}": [0.0, 1.0] for i in range(5)}, "problem_parameters": {},
        "n_initial": 4, "n_epochs": 2, "population_size": 16, "num_generations": 4,
        "resample_fraction": 0.5, "optimizer_name": "nsga2",
        "surrogate_method_name": "gpr",
        "surrogate_method_kwargs": {"n_starts": 2, "n_iter": 10, "seed": 0,
                                    "predictor": "matmul"},
        "random_seed": 7, "device": "cpu", "telemetry": False,
    }
    params.update(over)
    return params


def archive(opt_id: str):
    """(x, y) of a finished run's archive (problem 0)."""
    from dmosopt_tpu_torch.driver import dopt_dict

    strat = dopt_dict[opt_id].optimizer_dict[0]
    return np.asarray(strat.x), np.asarray(strat.y)


def nsga2_step(mesh=None):
    """One NSGA-II generation on ZDT1 from a seeded LH design (pop 16,
    dim 6); under a mesh its survival ranks are the sharded ones.
    Returns the new population's objectives."""
    from functools import partial

    from dmosopt_tpu_torch import sampling
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.ops.dominance import rank_route
    from dmosopt_tpu_torch.optimizers.nsga2 import NSGA2
    from dmosopt_tpu_torch.parallel.mesh import non_dominated_rank_sharded

    pop, dim = 16, 6
    bounds = np.stack([np.zeros(dim), np.ones(dim)], 1)
    x0 = sampling.lh(pop, dim, 0)
    y0 = zdt1(torch.as_tensor(x0, dtype=torch.float32)).numpy()
    opt = NSGA2(popsize=pop, nInput=dim, nOutput=2, model=None, device="cpu")
    opt.initialize_strategy(x0, y0, bounds, random=0)
    gen = torch.Generator().manual_seed(5)
    route = (rank_route(partial(non_dominated_rank_sharded, mesh=mesh, axis="pop"))
             if mesh is not None else contextlib.nullcontext())
    with route:
        x_gen, state = opt.generate_strategy(gen, opt.state)
        x_gen = torch.clamp(x_gen, 0.0, 1.0)
        state = opt.update_strategy(state, x_gen, zdt1(x_gen))
    return state.population_obj.numpy()


def _checks(out_dir: str, rank: int) -> None:
    from dmosopt_tpu_torch import run
    from dmosopt_tpu_torch.benchmarks.zdt import zdt1
    from dmosopt_tpu_torch.driver import dopt_dict
    from dmosopt_tpu_torch.models import gp, gp_sharded
    from dmosopt_tpu_torch.models.predictor import GPPredictor
    from dmosopt_tpu_torch.parallel.evaluator import TorchBatchEvaluator
    from dmosopt_tpu_torch.parallel.mesh import create_mesh, non_dominated_rank_sharded

    out = {}
    mesh = create_mesh(axis_names=("pop",), device="cpu")
    for d in (2, 3):
        Y, m = rank_inputs(d, 203, d)
        out[f"rank_d{d}"] = non_dominated_rank_sharded(
            torch.as_tensor(Y), mesh, mask=torch.as_tensor(m), tile=32).numpy()
    Y, m = rank_inputs(9, 157, 5)
    for shape in ((2, 1), (1, 2)):
        m2 = create_mesh(axis_names=("pop", "model"), shape=shape, device="cpu")
        out[f"rank_2axis_{shape[0]}{shape[1]}"] = non_dominated_rank_sharded(
            torch.as_tensor(Y), m2, axis="pop").numpy()

    ev = TorchBatchEvaluator(zdt1, "cpu", mesh=mesh)
    rows = np.random.default_rng(0).random((13, 6)).astype(np.float32)
    res = ev.evaluate_batch([{0: r} for r in rows])
    out["evaluator"] = np.stack([r[0] for r in res])

    out["nsga2_step"] = nsga2_step(mesh)

    X, Yg = gp_data(48)
    mesh_model = create_mesh(axis_names=("pop", "model"), shape=(1, 2), device="cpu")
    fit = gp.fit_gp_batch(torch.Generator().manual_seed(1), torch.as_tensor(X),
                          torch.as_tensor(Yg), n_starts=4, n_iter=30, mesh=mesh_model)
    Xq = torch.as_tensor(np.random.default_rng(3).random((64, 4)).astype(np.float32))
    out["model_split_amp"], out["model_split_ls"] = fit.amp.numpy(), fit.ls.numpy()
    out["model_split_mean"], out["model_split_var"] = (
        t.numpy() for t in gp.gp_predict(fit, Xq))

    plain = gp.fit_gp_batch(torch.Generator().manual_seed(2), torch.as_tensor(X),
                            torch.as_tensor(Yg), n_starts=2, n_iter=20)
    pred = GPPredictor(plain, "matern52", mode="matmul", mesh=mesh)
    out["query_mean"], out["query_var"] = (t.numpy() for t in pred.predict_normalized(Xq))

    Xs, Ys = gp_data(64, seed=4)
    tm = torch.as_tensor((np.arange(64) < 56).astype(np.float32))
    L, W, alpha, nmll = gp_sharded.posterior_sharded(
        torch.as_tensor(Xs), torch.as_tensor(Ys), tm, torch.tensor([1.3, 0.8]),
        torch.tensor([[0.4], [0.7]]), torch.tensor([1e-4, 3e-4]), rel_jitter=1e-4,
        mesh=mesh, tile=16)
    out["post_L"], out["post_W"], out["post_alpha"], out["post_nmll"] = (
        t.numpy() for t in (L, W, alpha, nmll))
    sh = gp_sharded.fit_gp_sharded(
        torch.Generator().manual_seed(2), torch.as_tensor(Xs), torch.as_tensor(Ys),
        train_mask=tm, mesh=mesh, tile=32, n_starts=2, n_iter=8)
    out["fit_nmll"], out["fit_ls"] = sh.nmll.numpy(), sh.ls.numpy()
    out["fit_mean"] = gp.gp_predict(sh, Xq)[0].numpy()

    best = run(run_params("mh_run", mesh=mesh), verbose=False)
    out["run_best_y"] = np.column_stack([v for _, v in best[1]])
    out["run_x"], out["run_y"] = archive("mh_run")

    store = os.path.join(out_dir, "store.h5")
    run(run_params("mh_resume", mesh=mesh, save=True, file_path=store), verbose=False)
    dopt = dopt_dict["mh_resume"]
    out["resume_x"], out["resume_y"] = archive("mh_resume")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"resuming": bool(dopt._resuming), "start_epoch": int(dopt.start_epoch)}, f)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _chip(json_path: str, rank: int) -> None:
    from dmosopt_tpu_torch.models import gp, gp_sharded
    from dmosopt_tpu_torch.ops.dominance import non_dominated_rank
    from dmosopt_tpu_torch.parallel.mesh import create_mesh, non_dominated_rank_sharded

    dev = torch.device("cuda", 0)
    mesh = create_mesh(device=dev)
    Y = torch.as_tensor(np.random.default_rng(11).random((16384, 3)).astype(np.float32),
                        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = non_dominated_rank_sharded(Y, mesh)
    torch.cuda.synchronize()
    t_rank = time.perf_counter() - t0
    ref = non_dominated_rank(Y)
    X, Yg = gp_data(2048, dim=8, seed=5)
    Xt, Yt = torch.as_tensor(X, device=dev), torch.as_tensor(Yg[:, :1], device=dev)
    kw = dict(n_starts=2, n_iter=8, convergence_tol=None)
    t0 = time.perf_counter()
    sh = gp_sharded.fit_gp_sharded(torch.Generator(dev).manual_seed(1), Xt, Yt,
                                   mesh=mesh, **kw)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    one = gp.fit_gp_batch(torch.Generator(dev).manual_seed(1), Xt, Yt, **kw)
    Xq = torch.as_tensor(np.random.default_rng(6).random((128, 8)).astype(np.float32),
                         device=dev)
    mean_err = float((gp.gp_predict(sh, Xq)[0] - gp.gp_predict(one, Xq)[0]).abs().max())
    rec = {
        "rank_rows": int(Y.shape[0]), "rank_equal": bool(torch.equal(sharded, ref)),
        "rank_fronts": int(ref.max()) + 1, "sharded_rank_s": t_rank,
        "fit_rows": int(Xt.shape[0]), "sharded_fit_s": t_fit,
        "nmll_sharded": float(sh.nmll[0]), "nmll_single": float(one.nmll[0]),
        "mean_max_abs_err": mean_err,
    }
    if rank == 0:
        with open(json_path, "w") as f:
            json.dump(rec, f)
    if not rec["rank_equal"]:
        raise AssertionError(f"sharded rank differs from the single-device rank: {rec}")


def main(argv) -> None:
    coordinator, n, rank, task, *rest = argv
    from dmosopt_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    rank = int(rank)
    device = "cuda" if task == "chip" else "cpu"
    initialize_distributed(coordinator, int(n), rank, device=device, backend="gloo")
    try:
        if task == "checks":
            _checks(rest[0], rank)
        elif task == "chip":
            _chip(rest[0], rank)
        else:
            raise ValueError(f"unknown task {task!r}")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
