"""Surrogate error of the large-archive run, in both packages, on the
CPU: the grounds of ``chip_smoke.py`` phase 12's bar.

Runs phase 12 (a)'s configuration (``chip_smoke.sparse_params``: ZDT1
with 30 parameters as a batched objective, NSGA-II, pop 200, 100
generations, 2 epochs, 150 initial points per parameter, that is 4500
rows, so `gpr` is rerouted to `svgp` every epoch; ``random_seed`` the
seed) through `dmosopt_tpu.run` and `dmosopt_tpu_torch.run`, and prints
per run:

- the rows the first epoch's fit resampled, how many of them the
  archive did not hold (in float32, the EA's precision), and the mean
  absolute error of their predictions per objective;
- per epoch, the gate's reading (``chip_smoke.sparse_error`` of
  ``chip_smoke.offspring_mae``): the error of the surrogate's values of
  the inner EA's offspring of the last 10 generations against ZDT1,
  averaged over the objectives, each over the standard deviation of the
  design's objective values.

With ``--zero-variational-mean`` the port's sparse fits have their
variational mean set to zero after fitting, so they predict the archive
mean: the copy the gate must fail.

    JAX_PLATFORMS=cpu python tools/sparse_quality.py --seeds 0 1 2
    JAX_PLATFORMS=cpu python tools/sparse_quality.py --packages torch --zero-variational-mean
    JAX_PLATFORMS=cpu python tools/sparse_quality.py --surrogate svgp --n-initial 3

(the last is phase 12 (b)'s `svgp` run, 90 design rows).

With ``--fit-only N`` it fits `svgp` alone (the class's defaults, seed
0) on N uniform random ZDT1 rows in each package and prints the fitted
hyperparameters, the final loss and the error of the predictions at 500
fresh uniform rows and at 500 rows of [0, 0.3]^30 (toward the front),
beside the error of predicting the training mean:

    JAX_PLATFORMS=cpu python tools/sparse_quality.py --fit-only 4500

A JAX run takes about 12 minutes on this configuration on a few CPU
cores; ``--n-initial`` cuts the design for a quick look (below 137
points per parameter the fit stays dense).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def capture_folds(strategy_cls, folds):
    """Wrap ``strategy_cls._update_evals`` so that each fold it makes is
    appended to ``folds`` as (archive before the fold, returned tuple);
    returns the original."""
    original = strategy_cls._update_evals

    def update_evals(self):
        x_prev = np.zeros((0, self.prob.dim)) if self.x is None else self.x.copy()
        out = original(self)
        if out is not None:
            folds.append((x_prev, out))
        return out

    strategy_cls._update_evals = update_evals
    return original


def zero_variational_mean(svgp):
    """Patch the port's ``svgp.fit_svgp`` so that each fit's variational
    mean is zero; returns the original."""
    original = svgp.fit_svgp

    def fit_svgp(*args, **kwargs):
        fit = original(*args, **kwargs)
        fit.params = fit.params._replace(vm=fit.params.vm * 0.0)
        return fit

    svgp.fit_svgp = fit_svgp
    return original


def run_once(package, seed, n_initial, zero_mean, surrogate="gpr"):
    if package == "jax":
        import dmosopt_tpu as pkg
        from dmosopt_tpu import driver, strategy
        from dmosopt_tpu.benchmarks.zdt import zdt1

        extra, kwargs = {"jax_objective": True}, {}
    else:
        import dmosopt_tpu_torch as pkg
        from dmosopt_tpu_torch import driver, strategy
        from dmosopt_tpu_torch.benchmarks.zdt import zdt1
        from dmosopt_tpu_torch.models import svgp

        extra, kwargs = {"torch_objective": True}, {"device": "cpu"}
    opt_id = f"sparse_{package}_{seed}"
    params = chip_smoke.sparse_params(opt_id, zdt1, n_initial=n_initial,
                                      random_seed=seed, surrogate_method_name=surrogate,
                                      **extra)
    folds = []
    restore = [(strategy.DistOptStrategy, "_update_evals",
                capture_folds(strategy.DistOptStrategy, folds))]
    if zero_mean:
        restore.append((svgp, "fit_svgp", zero_variational_mean(svgp)))
    try:
        t0 = time.perf_counter()
        with chip_smoke.capture_epoch_results(driver.DistOptimizer) as cap:
            best = pkg.run(params, verbose=False, **kwargs)
        wall = time.perf_counter() - t0
    finally:
        for obj, name, original in restore:
            setattr(obj, name, original)
    dopt = driver.dopt_dict[opt_id]
    # the design's fold, then each epoch's opening fold of the previous
    # epoch's resample batch
    y_design = folds[0][1][1]
    x_prev, (x, y, pred, _, _) = folds[-1]
    new = chip_smoke.new_rows(x, x_prev)
    mae_new = [float(v) for v in np.mean(np.abs(y[new] - pred[new][:, :2]), axis=0)] \
        if new.any() else [float("nan")] * 2
    surrogates = [s.get("surrogate") for s in getattr(dopt, "epoch_stats", [])]
    mae = [float(v) for v in np.mean(np.abs(y - pred[:, :2]), axis=0)]
    return {
        "wall": wall, "n_rows": x.shape[0], "n_new": int(new.sum()), "mae_new": mae_new,
        "resample_error": chip_smoke.sparse_error(mae, y_design),
        "errors": [chip_smoke.sparse_error(chip_smoke.offspring_mae(r), y_design)
                   for r in cap.results],
        "returned": len(best[0]), "surrogates": surrogates,
    }


def fit_only(package, n_rows):
    """Fit `svgp` on ``n_rows`` uniform random ZDT1 rows; print its
    hyperparameters, loss and prediction errors."""
    rng = np.random.default_rng(0)
    X = rng.random((n_rows, chip_smoke.SPARSE_DIM))
    Y = chip_smoke.zdt1_host(X)
    probes = {"uniform": rng.random((500, chip_smoke.SPARSE_DIM)),
              "toward the front": 0.3 * rng.random((500, chip_smoke.SPARSE_DIM))}
    box = (np.zeros(chip_smoke.SPARSE_DIM), np.ones(chip_smoke.SPARSE_DIM))
    t0 = time.perf_counter()
    if package == "jax":
        from dmosopt_tpu.models.svgp import SVGP_Matern, _unpack

        m = SVGP_Matern(X, Y, chip_smoke.SPARSE_DIM, 2, *box, seed=0)
    else:
        from dmosopt_tpu_torch.models.svgp import SVGP_Matern, _unpack

        m = SVGP_Matern(X, Y, chip_smoke.SPARSE_DIM, 2, *box, seed=0, device="cpu")
    wall = time.perf_counter() - t0
    f = m.fit
    amp, ls, noise = (np.asarray(v).ravel().tolist() for v in
                      _unpack(f.params, f.bounds_amp, f.bounds_ls, f.bounds_noise))
    errors = {}
    for name, xq in probes.items():
        yq = chip_smoke.zdt1_host(xq)
        mean = np.asarray(m.predict(xq)[0])
        errors[name] = (chip_smoke.sparse_error(np.abs(mean - yq).mean(0), Y),
                        chip_smoke.sparse_error(np.abs(Y.mean(0) - yq).mean(0), Y))
    print(f"{package} svgp on {n_rows} rows ({m.fit_info['n_inducing']} inducing): "
          f"{wall:.1f} s, loss {m.fit_info['loss']:.1f}, lengthscale {ls}, amplitude "
          f"{amp}, noise {noise}; error (the training mean's) " + ", ".join(
              f"{k} {v[0]:.4f} ({v[1]:.4f})" for k, v in errors.items()), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packages", nargs="+", default=["jax", "torch"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--n-initial", type=int, default=chip_smoke.SPARSE_N_INITIAL)
    ap.add_argument("--surrogate", default="gpr")
    ap.add_argument("--fit-only", type=int, default=None, metavar="N")
    ap.add_argument("--zero-variational-mean", action="store_true")
    args = ap.parse_args(argv)
    if "torch" in args.packages:
        import torch

        torch.set_num_threads(4)
    if args.fit_only is not None:
        for package in args.packages:
            fit_only(package, args.fit_only)
        return
    for seed in args.seeds:
        for package in args.packages:
            if args.zero_variational_mean and package != "torch":
                continue
            r = run_once(package, seed, args.n_initial, args.zero_variational_mean,
                         args.surrogate)
            label = "torch (zeroed variational mean)" if args.zero_variational_mean \
                else package
            print(f"{label} {args.surrogate} n_initial {args.n_initial} seed {seed}: "
                  f"{r['wall']:.1f} s; surrogates {r['surrogates']}; error on the "
                  f"{r['n_rows']} resampled rows {r['resample_error']:.4f} (bar "
                  f"{chip_smoke.SPARSE_ERROR_BAR}), {r['n_new']} of them new, their "
                  f"mean absolute error {r['mae_new']}; error on the last "
                  f"generations' offspring by epoch {r['errors']}; "
                  f"{r['returned']} returned",
                  flush=True)


if __name__ == "__main__":
    main()
