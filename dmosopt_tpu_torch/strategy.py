"""Per-problem optimization strategy: the request-queue state machine.

Port of ``dmosopt_tpu/strategy.py`` (reference `DistOptStrategy`,
dmosopt/dmosopt.py:43-544) on this slice's path: it owns the evaluated
points archive (x/y/c), a queue of pending `EvalRequest`s and the
per-epoch MO-ASMO generator, and exposes the `initialize_epoch` /
`update_epoch` transitions. In surrogate mode the epoch generator
completes in a single `next()` (the whole inner EA ran on the device);
in no-surrogate mode the per-generation request/complete cycle matches
the reference. ``initial=`` restores an archive read from the store
(a resumed run): the initial design then skips as many points as the
archive holds and drops any point already in it (`anyclose`; the JAX
package filters the same way, lazily, before any new row is folded).
``termination_conditions`` builds the epoch's stopping criterion as
the JAX package does (`_build_termination`); one criterion object
serves every epoch of the run, so its windows carry across epochs. The
feasibility and sensitivity methods pass through to each epoch. With
``surrogate_refit`` other than cold the strategy owns one
`SurrogateRefitController` whose state persists across its epochs (and,
seeded from ``surrogate_refit_state``, across a resume) and hands it to
every epoch's fit (``dmosopt_tpu/strategy.py:77-125, :413``). With
``optimize_mean_variance`` a prediction column block is 2·d wide, [mean,
variance], and a mean-only prediction gets zero variances
(``dmosopt_tpu/strategy.py:237-240, :335-338``). The rows folded into
the archive as an epoch opens (the previous epoch's resample batch, with
the predictions that scheduled them) stay in ``folded_evals`` for the
driver's surrogate-accuracy log. Features (``prob.feature_dtypes``) are
archived as flat float64 columns (``f``; `storage.feature_columns`) and
handed back through the problem's ``feature_constructor`` by
`get_best_evals` and `get_evals` (``dmosopt_tpu/strategy.py:75-99,
:378``); with ``persist_features`` a feature that cannot be columnized
fails at its first evaluation. ``surrogate_custom_training`` (an import
path) and its kwargs pass through to every epoch. The problem-batched
tenant core (`tenants.py`) opens an epoch with `open_epoch` and puts
its result in place with `install_epoch_result` (``:417-470``). The
ask/tell service checkpoints ``optimizer_draws`` (the optimizer-cycle
draws taken) and asks `has_completed`.
With a ``telemetry`` the initial design is an ``xinit`` phase (tagged
``xinit_epoch``, the run's first epoch, so a resumed run's summary keeps
it), a quarantined row counts in ``points_quarantined_total``, and each
epoch's engine records its spans and phases (``:155``, ``:281``).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from dmosopt_tpu_torch import moasmo as opt
from dmosopt_tpu_torch.config import as_tuple
from dmosopt_tpu_torch.datatypes import (
    EpochResults,
    EvalEntry,
    EvalRequest,
    OptProblem,
    StrategyState,
)
from dmosopt_tpu_torch.models.refit import (
    SurrogateRefitConfig,
    SurrogateRefitController,
)
from dmosopt_tpu_torch.moasmo import get_duplicates
from dmosopt_tpu_torch.ops import order_mo
from dmosopt_tpu_torch.storage import feature_columns
from dmosopt_tpu_torch.telemetry import phase_scope


def anyclose(x, Y, rtol: float = 1e-4, atol: float = 1e-4) -> bool:
    """True if any row of Y is elementwise-close to x (the reference's
    per-row allclose loop, dmosopt/dmosopt.py:36-40, as one comparison)."""
    x = np.asarray(x)
    return bool(np.any(np.all(np.abs(Y - x) <= atol + rtol * np.abs(Y), axis=1)))


def _vstack_or_init(base, rows):
    """Append rows to a growing archive column (None = first batch)."""
    if rows is None:
        return base
    return rows if base is None else np.concatenate((base, rows), axis=0)


class DistOptStrategy:
    def __init__(
        self,
        prob: OptProblem,
        *,
        n_initial: int = 10, initial=None,
        initial_method: str = "slh", initial_maxiter: int = 5,
        population_size: int = 100, num_generations: int = 100,
        resample_fraction: float = 0.25,
        distance_metric=None, termination_conditions=None,
        optimizer_name="nsga2",
        optimizer_kwargs=None,
        surrogate_method_name: Optional[str] = "gpr",
        surrogate_method_kwargs: Optional[Dict] = None,
        surrogate_refit=None,
        surrogate_refit_state: Optional[Dict] = None,
        sensitivity_method_name: Optional[str] = None,
        sensitivity_method_kwargs: Optional[Dict] = None,
        feasibility_method_name=None,
        feasibility_method_kwargs: Optional[Dict] = None,
        optimize_mean_variance: bool = False,
        surrogate_custom_training: Optional[str] = None,
        surrogate_custom_training_kwargs: Optional[Dict] = None,
        persist_features: bool = False, file_path=None,
        local_random=None, logger=None, device=None,
        telemetry=None, xinit_epoch: int = 0,
    ):
        self.__dict__.update(
            prob=prob,
            local_random=local_random,
            logger=logger,
            device=device,
            surrogate_method_name=surrogate_method_name,
            sensitivity_method_name=sensitivity_method_name,
            feasibility_method_name=feasibility_method_name,
            distance_metric=distance_metric,
            resample_fraction=resample_fraction,
            num_generations=num_generations,
            population_size=population_size,
            optimize_mean_variance=optimize_mean_variance,
            surrogate_custom_training=surrogate_custom_training,
            surrogate_custom_training_kwargs=surrogate_custom_training_kwargs,
            persist_features=persist_features, file_path=file_path,
            telemetry=telemetry,
        )
        self.surrogate_method_kwargs = surrogate_method_kwargs or {}
        # cross-epoch surrogate reuse: one controller per problem; "cold"
        # (the default) keeps it out of the loop
        self.surrogate_refit = surrogate_refit
        self.refit_controller = None
        refit_cfg = SurrogateRefitConfig.from_spec(surrogate_refit)
        if refit_cfg.mode != "cold":
            self.refit_controller = SurrogateRefitController(
                refit_cfg, logger=logger, seed_state=surrogate_refit_state
            )
        self.sensitivity_method_kwargs = sensitivity_method_kwargs or {}
        self.feasibility_method_kwargs = feasibility_method_kwargs or {}
        self.optimizer_name = as_tuple(optimizer_name)
        self.optimizer_kwargs = as_tuple(
            optimizer_kwargs
            if optimizer_kwargs is not None
            else {"crossover_prob": 0.9, "mutation_prob": 0.1}
        )
        self.optimizer_iter = itertools.cycle(range(len(self.optimizer_name)))
        # draws taken from optimizer_iter: a service checkpoint stores the
        # count and a resume replays it (``dmosopt_tpu/strategy.py:133``)
        self.optimizer_draws = 0
        self.termination = self._build_termination(termination_conditions)

        self.completed = []
        # per-evaluation wall times: the JAX package's column, which a
        # service checkpoint carries; the port keeps the times in the
        # driver's round statistics and leaves it None
        self.t = None
        self.x = self.y = self.f = self.c = None
        if initial is not None:
            # (epochs, x, y, f, c) restored from the store
            _epochs, self.x, self.y, self.f, self.c = initial

        # seed the request queue with the initial design; on resume the
        # design skips as many points as the archive holds and drops the
        # points already in it
        n_previous = None if self.x is None else self.x.shape[0]
        with phase_scope(telemetry, "xinit", epoch=xinit_epoch) as ph:
            xinit = opt.xinit(
                n_initial, prob.param_names, prob.lb, prob.ub,
                method=initial_method, maxiter=initial_maxiter,
                nPrevious=n_previous, local_random=self.local_random,
                logger=self.logger,
            )
            if xinit is not None:
                ph["n_points"] = int(xinit.shape[0])
        self.reqs = deque()
        if xinit is not None:
            if xinit.shape[1] != prob.dim:
                raise ValueError(
                    f"initial design dim {xinit.shape[1]} != problem dim {prob.dim}"
                )
            self.reqs.extend(
                EvalRequest(row, None, 0) for row in xinit
                if initial is None or not anyclose(row, self.x)
            )
        self.opt_gen = None
        self.epoch_index = -1
        self.folded_evals = None
        self._epoch_opened = False
        self.stats = {}
        self.n_quarantined = 0

    def _build_termination(self, conditions):
        """None/falsy -> no criterion; a callable -> called with the
        problem; a dict/True -> the adaptive composite with overrides
        (reference ``dmosopt_tpu/strategy.py:188-200``), whose
        hypervolume estimators run on the run's device."""
        if not conditions:
            return None
        if callable(conditions):
            return conditions(self.prob)
        from dmosopt_tpu_torch.adaptive_termination import create_adaptive_termination

        overrides = conditions if isinstance(conditions, dict) else {}
        spec = dict(strategy="comprehensive", n_max_gen=self.num_generations)
        spec.update(overrides)
        return create_adaptive_termination(self.prob, device=self.device, **spec)

    # ------------------------------------------------------- request queue

    def append_request(self, req: EvalRequest):
        self.reqs.append(req)

    def has_requests(self) -> bool:
        return len(self.reqs) > 0

    def get_next_request(self) -> Optional[EvalRequest]:
        return self.reqs.popleft() if self.reqs else None

    def has_completed(self) -> bool:
        return len(self.completed) > 0

    def complete_request(self, x, y, epoch=None, f=None, c=None, pred=None, time=-1.0):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape[0] != self.prob.dim or y.shape[0] != self.prob.n_objectives:
            raise ValueError(f"result shapes {x.shape}, {y.shape} do not fit the problem")
        if self.optimize_mean_variance and pred is not None:
            pred = np.asarray(pred)
            if pred.shape[0] == self.prob.n_objectives:
                # a mean-only prediction: zero variances beside it
                pred = np.concatenate((pred, np.zeros_like(pred)))
        if f is not None:
            # the archive keeps features as flat float columns; records
            # with non-numeric fields pass through raw unless the run
            # persists, which fails on the first such evaluation
            try:
                f = feature_columns(f).reshape(1, -1)
            except TypeError:
                if self.persist_features:
                    raise
                if np.ndim(f) == 1:
                    f = np.reshape(f, (1, -1))
        entry = EvalEntry(epoch, x, y, f, c, pred, time)
        if not np.all(np.isfinite(y.astype(np.float64, copy=False))):
            # a non-finite objective never reaches the archive: one NaN
            # row would poison the standardized GP training targets
            self.n_quarantined += 1
            self.stats["n_quarantined"] = self.n_quarantined
            if self.logger is not None:
                self.logger.warning(
                    f"quarantined non-finite objective row (y={y.tolist()}); "
                    f"{self.n_quarantined} total"
                )
            if self.telemetry:
                self.telemetry.inc("points_quarantined_total")
            return None
        self.completed.append(entry)
        return entry

    # ----------------------------------------------------- archive upkeep

    def _remove_duplicate_evals(self):
        is_duplicate = get_duplicates(self.x, device=self.device)
        self.x = self.x[~is_duplicate]
        self.y = self.y[~is_duplicate]
        if self.f is not None:
            self.f = self.f[~is_duplicate]
        if self.c is not None:
            self.c = self.c[~is_duplicate]

    def _reduce_evals(self):
        """Trim the archive to the best `population_size` points
        (reference dmosopt.py:219-229), ranked on the run's device."""
        self._remove_duplicate_evals()
        dev = self.device
        perm, _, _ = order_mo(
            torch.as_tensor(self.x, device=dev), torch.as_tensor(self.y, device=dev),
            need=self.population_size,
        )
        perm = perm[: self.population_size].cpu().numpy()
        self.x = self.x[perm, :]
        self.y = self.y[perm, :]
        if self.c is not None:
            self.c = self.c[perm, :]
        if self.f is not None:
            self.f = self.f[perm]

    def _update_evals(self):
        """Fold completed evaluations into the archive once the request
        queue is drained (reference dmosopt.py:229-305)."""
        if not self.completed or self.has_requests():
            return None
        done = self.completed
        x = np.vstack([e.parameters for e in done])
        y = np.vstack([e.objectives for e in done])
        f = (
            np.concatenate([e.features for e in done], axis=0)
            if self.prob.n_features is not None
            else None
        )
        c = (
            np.vstack([e.constraints for e in done])
            if self.prob.n_constraints is not None
            else None
        )
        n_pred_cols = self.prob.n_objectives * (2 if self.optimize_mean_variance else 1)
        nan_pred = [np.nan] * n_pred_cols
        pred = np.vstack(
            [nan_pred if e.prediction is None else e.prediction for e in done]
        )
        if c is not None and c.shape[1] != self.prob.n_constraints:
            raise ValueError(
                f"completed evals: c has {c.shape[1]} columns, "
                f"expected {self.prob.n_constraints}"
            )
        self.x = _vstack_or_init(self.x, x)
        self.y = _vstack_or_init(self.y, y)
        self.f = _vstack_or_init(self.f, f)
        self.c = _vstack_or_init(self.c, c)
        self._remove_duplicate_evals()
        self.completed = []
        return x, y, pred, f, c

    # ------------------------------------------------------- epoch driving

    def _cycled_optimizer(self):
        """(name, kwargs) for this epoch's optimizer."""
        if len(self.optimizer_kwargs) not in (1, len(self.optimizer_name)):
            raise ValueError(
                f"optimizer_kwargs has {len(self.optimizer_kwargs)} entries "
                f"for {len(self.optimizer_name)} optimizers; pass one dict "
                f"or one per optimizer"
            )
        idx = next(self.optimizer_iter)
        self.optimizer_draws += 1
        merged = dict(self.optimizer_kwargs[idx % len(self.optimizer_kwargs)] or {})
        if self.distance_metric is not None:
            merged["distance_metric"] = self.distance_metric
        return self.optimizer_name[idx], merged

    def open_epoch(self):
        """Fold the evaluations completed since the last epoch (the
        previous epoch's resample batch) into the archive and keep them
        in ``folded_evals``. `initialize_epoch` does it unless the batched
        core already has, to decide eligibility on the folded archive."""
        self.folded_evals = self._update_evals()
        self._epoch_opened = True

    def initialize_epoch(self, epoch_index: int):
        if self.opt_gen is not None:
            raise RuntimeError("an epoch is already active for this strategy")
        name, okw = self._cycled_optimizer()
        if not self._epoch_opened:
            self.open_epoch()
        self._epoch_opened = False

        if epoch_index <= self.epoch_index:
            raise ValueError(f"epoch {epoch_index} does not follow {self.epoch_index}")
        self.epoch_index = epoch_index
        self.opt_gen = opt.epoch(
            self.num_generations, self.prob.param_names,
            self.prob.objective_names, self.prob.lb, self.prob.ub,
            self.resample_fraction, self.x, self.y, self.c,
            pop=self.population_size,
            optimizer_name=name, optimizer_kwargs=okw,
            surrogate_method_name=self.surrogate_method_name,
            surrogate_method_kwargs=self.surrogate_method_kwargs,
            sensitivity_method_name=self.sensitivity_method_name,
            sensitivity_method_kwargs=self.sensitivity_method_kwargs,
            feasibility_method_name=self.feasibility_method_name,
            feasibility_method_kwargs=self.feasibility_method_kwargs,
            surrogate_refit=self.refit_controller,
            surrogate_custom_training=self.surrogate_custom_training,
            surrogate_custom_training_kwargs=self.surrogate_custom_training_kwargs,
            file_path=self.file_path,
            optimize_mean_variance=self.optimize_mean_variance,
            termination=self.termination,
            local_random=self.local_random, logger=self.logger,
            device=self.device, telemetry=self.telemetry,
        )
        try:
            x_gen, reduce_evals = next(self.opt_gen)
        except StopIteration as ex:
            # surrogate mode: the epoch completed on the device in one shot;
            # stash the result dict for update_epoch (ref dmosopt.py:352-358)
            self.opt_gen.close()
            self.opt_gen = ex.value
            return
        if reduce_evals:
            self._reduce_evals()
        for row in x_gen:
            self.append_request(EvalRequest(row, None, self.epoch_index))

    def install_epoch_result(self, epoch_index: int, result: dict):
        """Put in place an epoch computed outside `initialize_epoch`: the
        batched tenant core advances a bucket of strategies at once and
        hands each its surrogate-mode result dict here, which
        `update_epoch` then completes exactly as a result stashed by
        `initialize_epoch` (resample requests, stats)."""
        if self.opt_gen is not None:
            raise RuntimeError("an epoch is already active for this strategy")
        if epoch_index <= self.epoch_index:
            raise ValueError(f"epoch {epoch_index} does not follow {self.epoch_index}")
        self._epoch_opened = False
        self.epoch_index = epoch_index
        self.opt_gen = result

    def _complete_from_result(self, res, resample: bool):
        """The epoch generator's result dict as (CompletedEpoch,
        EpochResults); a surrogate-mode result also enqueues the resample
        batch for real evaluation next epoch."""
        self.stats.update(res.get("stats", {}))
        if "best_x" in res:  # no-surrogate mode: archive bests, no resample
            picked = (res["best_x"], res["best_y"], res["gen_index"],
                      res["x"], res["y"], res["optimizer"])
            return StrategyState.CompletedEpoch, EpochResults(*picked)
        x_resample, y_pred = res["x_resample"], res["y_pred"]
        if resample and x_resample is not None:
            for row, pred in zip(x_resample, y_pred):
                self.append_request(EvalRequest(row, pred, self.epoch_index + 1))
        picked = (x_resample, y_pred, res["gen_index"],
                  res["x_sm"], res["y_sm"], res["optimizer"])
        return StrategyState.CompletedEpoch, EpochResults(*picked)

    def update_epoch(self, resample: bool = False):
        """Advance the epoch state machine; returns
        (StrategyState, value, completed_evals) — reference dmosopt.py:368-504."""
        if self.opt_gen is None:
            raise RuntimeError("epoch not initialized")
        completed_evals = self._update_evals()
        if completed_evals is None and self.has_requests():
            return StrategyState.WaitingRequests, None, None

        if isinstance(self.opt_gen, dict):
            stashed, self.opt_gen = self.opt_gen, None
            state, value = self._complete_from_result(stashed, resample)
            return state, value, completed_evals

        try:
            if completed_evals is None:
                item, reduce_evals = next(self.opt_gen)
            else:
                feedback = (completed_evals[0], completed_evals[1], completed_evals[4])
                item, reduce_evals = self.opt_gen.send(feedback)
        except StopIteration as ex:
            self.opt_gen.close()
            self.opt_gen = None
            state, value = self._complete_from_result(ex.value, resample)
            return state, value, completed_evals

        if reduce_evals:
            self._reduce_evals()
        for row in item:
            self.append_request(EvalRequest(row, None, self.epoch_index))
        return StrategyState.EnqueuedRequests, item, completed_evals

    # ------------------------------------------------------------ queries

    def get_best_evals(self, feasible: bool = True):
        """(x, y, features, c) of the archive's non-dominated rows; the
        features through the problem's constructor."""
        if self.x is None:
            return None, None, None, None
        bestx, besty, bestf, bestc, _, _ = opt.get_best(
            self.x, self.y, self.f, self.c,
            self.prob.dim, self.prob.n_objectives, feasible=feasible,
            device=self.device,
        )
        return bestx, besty, self.prob.feature_constructor(bestf), bestc

    def get_evals(self, return_features: bool = False, return_constraints: bool = False):
        out = [self.x, self.y]
        if return_features:
            out.append(
                self.prob.feature_constructor(self.f) if self.f is not None else None
            )
        if return_constraints:
            out.append(self.c)
        return tuple(out)
