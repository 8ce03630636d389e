"""The comparison that decides ``correct``.

Each audited calibration is an answer: its final front (x, y), the
batches its objective was called with, and, for each epoch, the GP
hyperparameters the program fitted, the marginal likelihood it reported,
the resample batch its inner EA chose and the surrogate means the EA gave
that batch. The reference works out again, in float64, the objective at
every evaluated row, the non-dominated set of what it returned, the objective values of each
epoch's training rows and their standardisation, the marginal likelihood at the
program's hyperparameters and the posterior mean at the resample batch.
The GP fit is judged by where it ended (``fit_slack``): the reference
cannot retrace the program's random restarts, so it checks that Adam,
started at the program's answer, finds little left to gain.

Numbers, each the worst over the audited answers (``ea_dominated`` the
median over the audited epochs, since a share of one batch swings with
its surrogate); a cell's limits file names the numbers it holds:

- ``missing``: audited answers due in the window that never came;
- ``obj_gap``: max |y - f(x)| / (1 + |f(x)|) over the fronts' rows;
- ``front_gap``: objective vectors in one of the front and the
  non-dominated set of the values the objective returned, but not the
  other;
- ``train_rows_gap``: rows evaluated before a fit that it left out, and
  rows it fitted that were never evaluated (compared as float32 rows: the
  program keeps a float64 design row and its float32 copy apart, and fits
  both, as float32, so they coincide there);
- ``pred_gap``: max |EA's surrogate mean - posterior mean| / the
  objective's standard deviation, over the resample batches (a resample
  row that is an archive row carries the archive's value in the EA, and
  is held to the objective there);
- ``nmll_gap``: max |reported NMLL - NMLL| / max(1, |NMLL|);
- ``fit_slack``: max over objectives of the share of the NMLL that 30
  steps of Adam from the program's hyperparameters still remove;
- ``ea_dominated``: the share of a resample batch whose posterior means
  some training row's posterior mean dominates (with two objectives; with
  five, a batch that never evolved is as seldom dominated as one that
  did, so a cell's limits leave it out there);
- ``ea_stall``: max over the epochs of the hypervolume of the EA's
  initial pool (the training rows by their objective values, the
  initial design by its posterior means) over that of the pool and the
  resample batch together (the batch by the values the EA holds), where
  the record holds the design (the tenant core's epochs). A batch the EA
  never evolved is drawn from the pool and reads exactly 1; one it
  evolved covers more, and reads less.

``control=True`` puts the reference in the program's place in the
nearest precision below the configuration's float32 with TF32 off: the
GP's marginal likelihood and means with TF32 matrix products (where the
TF32 Gram matrix is not positive definite, that epoch gives no number and
the control's reading is the worst of the others), and the objective,
which has no matrix product, in bfloat16.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h100bench.reference import gp as rgp
from h100bench.reference import pareto, problems

NUMBERS = ("missing", "obj_gap", "front_gap", "train_rows_gap", "pred_gap",
           "nmll_gap", "fit_slack", "ea_dominated", "ea_stall")
SLACK_STEPS = 30


def _bf16(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(torch.bfloat16).double().numpy()


def _worst(cur, v):
    """The larger of two readings, a NaN (a comparison that gave no number)
    counting as infinite."""
    v = float(v)
    return float("inf") if v != v else max(cur, v)


def _worst_of_numbers(cur, v):
    """The control's reading: the larger of the readings that are numbers
    (where its Cholesky fails the control has failed outright there)."""
    v = float(v)
    return cur if v != v else max(cur, v)


def _rows(x):
    x32 = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    return [r.tobytes() for r in x32]


def judge(answers: List[Dict[str, Any]], config: Dict[str, Any], missing: int,
          device, control: bool = False) -> Dict[str, Optional[float]]:
    if [float(b) for b in config["parameter_bounds"]] != [0.0, 1.0]:
        raise ValueError("the check reads a fit's unit-box inputs as objective "
                         "inputs: it needs the box [0, 1]")
    f = problems.load(config["problem"])
    params = dict(config.get("problem_params") or {})
    gpc = config["gp"]
    rel_jitter = float(gpc["rel_jitter"])
    dt = torch.float64
    bounds = (rgp.Bounds(*gpc["constant_kernel_bounds"], dt, device),
              rgp.Bounds(*gpc["length_scale_bounds"], dt, device),
              rgp.Bounds(*gpc["noise_level_bounds"], dt, device))
    worst = _worst_of_numbers if control else _worst
    out = {k: 0.0 for k in NUMBERS}
    out["missing"] = float(missing)
    dominated = []
    n_epochs = 0
    for ans in answers:
        seqs = np.array([c[0] for c in ans["calls"]])
        xs = [c[1].double().cpu().numpy() for c in ans["calls"]]
        rows_seq = np.concatenate([np.full(len(x), s) for s, x in zip(seqs, xs)])
        X_all = np.concatenate(xs)
        Y_all = f(X_all, **params)

        fx = np.asarray(ans["front_x"], dtype=np.float64)
        fy = np.asarray(ans["front_y"], dtype=np.float64)
        if control:
            fy = _bf16(f(_bf16(fx), **params))
        want = f(fx, **params)
        out["obj_gap"] = max(out["obj_gap"],
                             float(np.max(np.abs(fy - want) / (1.0 + np.abs(want)))))
        # the front is the archive's non-dominated set by the values the
        # objective returned (float32 ties, such as DTLZ2's zeros at the
        # box's edge, fall as float32 breaks them); compared as sets of
        # objective vectors, since the program keeps one row of equal ones
        Y_ret = np.unique(np.concatenate([c[2].double().cpu().numpy() for c in ans["calls"]]),
                          axis=0)
        truth = set(_rows(Y_ret[pareto.non_dominated(Y_ret)]))
        got = set(_rows(np.asarray(ans["front_y"])))
        out["front_gap"] = max(out["front_gap"], float(len(truth ^ got)))
        evaluated = _rows(X_all)
        for ep in ans["epochs"]:
            n_epochs += 1
            # the fit's own training rows, each an evaluated row (the unit
            # box is the configurations' box, so its inputs are the
            # objective's), with the reference's objective values
            Xt = ep["x_train"].double().cpu().numpy()
            before = set(k for k, s in zip(evaluated, rows_seq) if s < ep["seq"])
            out["train_rows_gap"] = max(out["train_rows_gap"],
                                        float(len(before ^ set(_rows(Xt)))))
            Yt = f(Xt, **params)
            X = torch.as_tensor(Xt, dtype=dt, device=device)
            Yn, mean, std = rgp.standardise(torch.as_tensor(Yt, dtype=dt, device=device))
            amp = ep["amp"].to(device=device, dtype=dt)
            ls = ep["ls"].to(device=device, dtype=dt)
            noise = ep["noise"].to(device=device, dtype=dt)
            xr = torch.as_tensor(ep["x_resample"], dtype=dt, device=device)
            ref_nmll = rgp.nmll(X, Yn, amp, ls, noise, rel_jitter)
            mu = rgp.posterior_mean(X, Yn, mean, std, amp, ls, noise, xr, rel_jitter)
            if control:
                f32 = lambda t: t.float()  # noqa: E731
                got_nmll = rgp.nmll(f32(X), f32(Yn), f32(amp), f32(ls), f32(noise),
                                    rel_jitter, tf32=True).double()
                y_pred = rgp.posterior_mean(f32(X), f32(Yn), f32(mean), f32(std), f32(amp),
                                            f32(ls), f32(noise), f32(xr), rel_jitter,
                                            tf32=True).double()
            else:
                got_nmll = ep["nmll"].to(device=device, dtype=dt)
                y_pred = torch.as_tensor(ep["y_pred"], dtype=dt, device=device)
            out["nmll_gap"] = worst(out["nmll_gap"], torch.max(
                torch.abs(got_nmll - ref_nmll) / torch.clamp(ref_nmll.abs(), min=1.0)))
            # a resample row that is (as float32) an archive row carries
            # the archive's value in the EA, not a surrogate mean
            trained = set(_rows(Xt))
            known = torch.as_tensor([k in trained for k in _rows(ep["x_resample"])],
                                    device=device)
            want = torch.where(known[:, None], torch.as_tensor(
                f(ep["x_resample"], **params), dtype=dt, device=device), mu)
            out["pred_gap"] = worst(out["pred_gap"], torch.max(torch.abs(y_pred - want) / std))
            if ep["x_init"] is not None:
                xi = torch.as_tensor(ep["x_init"], dtype=dt, device=device)
                mu_init = rgp.posterior_mean(X, Yn, mean, std, amp, ls, noise, xi, rel_jitter)
                pool = np.vstack([Yt, mu_init.cpu().numpy()])
                out["ea_stall"] = _worst(out["ea_stall"],
                                         pareto.hv_stall(pool, want.cpu().numpy()))
            slack = rgp.nmll_slack(X, Yn, amp, ls, noise, bounds, float(gpc["learning_rate"]),
                                   SLACK_STEPS, rel_jitter)
            out["fit_slack"] = worst(out["fit_slack"], torch.max(slack))
            mu_train = rgp.posterior_mean(X, Yn, mean, std, amp, ls, noise, X, rel_jitter)
            dominated.append(float(np.mean(pareto.dominated_by_any(
                mu.cpu().numpy(), mu_train.cpu().numpy()))))
    out["ea_dominated"] = float(np.median(dominated)) if dominated else 0.0
    if not answers or n_epochs == 0:
        # nothing to judge: no number may pass
        for k in NUMBERS[1:]:
            out[k] = None
    return out


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at most its limit."""
    rows = [(k, numbers.get(k), float(limits[k])) for k in NUMBERS if k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
