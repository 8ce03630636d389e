"""Cross-epoch surrogate reuse: warm-started refits, rank-k posterior
updates and restart pruning.

Port of ``dmosopt_tpu/models/refit.py``. `SurrogateRefitController` is
a host-side state machine owned by one `DistOptStrategy` and called from
`moasmo.train`. Per fit it takes one of these paths:

- ``cold``: the from-scratch multi-restart fit (the first fit, or a warm
  state that no longer fits the configuration). ``mode="cold"`` keeps
  the controller out of the loop entirely.
- ``audit``: a full-restart cold fit every ``audit_every`` fits, which
  re-opens the global search and resets the schedule.
- ``warm``: `fit_gp_batch` with restart 0 at the previous converged
  hyperparameters and the others jittered around them, with the step
  budget capped; after ``prune_after`` consecutive wins of the warm
  slot the restarts are cut to ``pruned_starts``.
- ``rank``: once the hyperparameters have stayed put for
  ``rank_update_after`` refits and the training set only grew at its
  end, no Adam at all: the cached factor is extended for the k new rows
  (`gp.extend_cholesky_rank_k`, O(N²k)), and a built matmul predictor
  with it (`GPPredictor.after_rank_update`).
- ``rank_refactor``: the same when the append crosses the padding
  bucket: a refactorization at the fixed hyperparameters
  (`gp.posterior_from_params`).

The append check compares the new training inputs with the cached ones
bit for bit, on the host: each model keeps its padded inputs there
(``_X_host``), so a refit makes at most one device-to-host copy of X
(for a fit carried over from elsewhere). The state exports to a
JSON-able dict (`export_state`), which the driver stores with the
checkpoint in the JAX package's format, and a resumed run seeds its
controller from it (its first fit is warm: no factor is cached).

With a ``telemetry`` (`moasmo.train` hands the run's down) each fit
emits a ``surrogate_refit`` event naming its path, and the warm, audit
and rank paths count in ``gp_warm_starts_total``,
``gp_refit_audits_total``, ``gp_rank_updates_total``,
``gp_rank_update_rows_total`` and ``gp_refit_steps_saved_total``, as
the JAX controller's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

#: refit modes accepted by the driver's ``surrogate_refit`` option
REFIT_MODES = ("cold", "warm")


class SurrogateRefitConfig:
    """Resolved form of the ``surrogate_refit`` option (reference
    refit.py:69-168).

    mode: ``"cold"`` (default: from-scratch refits) or ``"warm"``.
    hyper_tol: largest log-space movement of the mean-shaping
        hyperparameters (lengthscales and the effective-noise-to-
        amplitude ratio) for a refit to count as stable.
    amp_tol: log-space amplitude movement tolerance (looser: the
        amplitude only rescales the variance).
    rank_update_after: consecutive stable refits before rank updates.
    prune_after: consecutive warm-slot wins before pruning restarts.
    pruned_starts: restart count once pruned.
    audit_every: every N-th fit is a full-restart cold audit.
    warm_iter_cap: fraction of the cold ``n_iter`` a warm refit may run
        (None: no cap).
    """

    __slots__ = (
        "mode", "hyper_tol", "amp_tol", "rank_update_after", "prune_after",
        "pruned_starts", "audit_every", "warm_iter_cap",
    )

    def __init__(
        self,
        mode: str = "cold",
        hyper_tol: float = 0.1,
        amp_tol: float = 0.7,
        rank_update_after: int = 1,
        prune_after: int = 2,
        pruned_starts: int = 2,
        audit_every: int = 5,
        warm_iter_cap: Optional[float] = 0.25,
    ):
        if mode not in REFIT_MODES:
            raise ValueError(f"surrogate_refit mode {mode!r} not in {REFIT_MODES}")
        if not (hyper_tol > 0.0):
            raise ValueError(f"hyper_tol must be > 0; got {hyper_tol}")
        if not (amp_tol > 0.0):
            raise ValueError(f"amp_tol must be > 0; got {amp_tol}")
        if rank_update_after < 0:
            raise ValueError("rank_update_after must be >= 0")
        if prune_after < 0:
            raise ValueError("prune_after must be >= 0")
        if pruned_starts < 1:
            raise ValueError("pruned_starts must be >= 1")
        if audit_every < 2:
            raise ValueError("audit_every must be >= 2")
        if warm_iter_cap is not None and not (0.0 < warm_iter_cap <= 1.0):
            raise ValueError(
                f"warm_iter_cap must be in (0, 1] or None; got {warm_iter_cap}"
            )
        self.mode = mode
        self.hyper_tol = float(hyper_tol)
        self.amp_tol = float(amp_tol)
        self.rank_update_after = int(rank_update_after)
        self.prune_after = int(prune_after)
        self.pruned_starts = int(pruned_starts)
        self.audit_every = int(audit_every)
        self.warm_iter_cap = float(warm_iter_cap) if warm_iter_cap is not None else None

    @classmethod
    def from_spec(cls, spec) -> "SurrogateRefitConfig":
        """None -> cold; a mode string; a dict of constructor keywords
        (``"mode"`` required, so a tuning dict never silently means
        cold); or a ready-made config."""
        if spec is None:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(mode=spec)
        if isinstance(spec, dict):
            if "mode" not in spec:
                raise ValueError(
                    "surrogate_refit dict must name 'mode' explicitly "
                    "(e.g. {'mode': 'warm', ...}); without it the tuning "
                    "options would silently apply to the cold default"
                )
            return cls(**spec)
        raise TypeError(
            f"surrogate_refit must be None, str, dict, or "
            f"SurrogateRefitConfig; got {type(spec)!r}"
        )


def _hyper_movement(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Log-space movement between two hyperparameter snapshots
    (reference refit.py:171): ``mean`` over the lengthscales and the
    effective-noise-to-amplitude ratio (what the posterior mean depends
    on), ``amp`` over the amplitude alone."""
    ratio_a = a["eff_noise"] / a["amp"]
    ratio_b = b["eff_noise"] / b["amp"]
    mean_mv = max(
        float(np.max(np.abs(np.log(a["ls"]) - np.log(b["ls"])))),
        float(np.max(np.abs(np.log(ratio_a) - np.log(ratio_b)))),
    )
    amp_mv = float(np.max(np.abs(np.log(a["amp"]) - np.log(b["amp"]))))
    return {"mean": mean_mv, "amp": amp_mv}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class SurrogateRefitController:
    """Per-problem state machine choosing each epoch's refit path
    (reference refit.py:198-588); see the module docstring."""

    def __init__(self, config: SurrogateRefitConfig, logger=None,
                 seed_state: Optional[dict] = None):
        self.config = config
        self.logger = logger
        self._model = None  # previous fitted surrogate (its factor cached)
        self._hyper: Optional[Dict[str, np.ndarray]] = None
        self._y_mean = self._y_std = None
        self._n_train = 0
        self._n_iter_max = 0  # the cold n_iter budget
        self._stable = 0
        self._warm_wins = 0
        self._fits_since_audit = 0
        self._unsupported_warned = False
        self.last_path: Optional[str] = None
        self.path_history: list = []
        if seed_state:
            self._seed(seed_state)

    # ------------------------------------------------------- persistence

    def _seed(self, state: dict):
        """Adopt a checkpointed `export_state` dict: hyperparameters and
        schedule counters only, so the first fit after a resume is warm."""
        try:
            amp = np.asarray(state["amp"], dtype=np.float64)
            noise = np.asarray(state["noise"], dtype=np.float64)
            self._hyper = {
                "amp": amp,
                "ls": np.asarray(state["ls"], dtype=np.float64),
                "noise": noise,
                "eff_noise": (
                    np.asarray(state["eff_noise"], dtype=np.float64)
                    if "eff_noise" in state
                    # a state without it: the float32 default floor
                    else noise + 1e-6 + 1e-4 * amp
                ),
            }
        except (KeyError, TypeError, ValueError):
            if self.logger is not None:
                self.logger.warning(
                    "surrogate_refit: unusable checkpoint state; first fit will run cold"
                )
            self._hyper = None
            return
        self._stable = int(state.get("stable", 0))
        self._warm_wins = int(state.get("warm_wins", 0))
        self._fits_since_audit = int(state.get("fits_since_audit", 0))
        self._n_train = int(state.get("n_train", 0))
        self._n_iter_max = int(state.get("n_iter_max", 0))

    @property
    def has_state(self) -> bool:
        return self._hyper is not None

    def export_state(self) -> Optional[dict]:
        """JSON-able warm state for the checkpoint (None before the first
        fit)."""
        if self._hyper is None:
            return None
        return {
            "amp": self._hyper["amp"].tolist(),
            "ls": self._hyper["ls"].tolist(),
            "noise": self._hyper["noise"].tolist(),
            "eff_noise": self._hyper["eff_noise"].tolist(),
            "stable": self._stable,
            "warm_wins": self._warm_wins,
            "fits_since_audit": self._fits_since_audit,
            "n_train": self._n_train,
            "n_iter_max": self._n_iter_max,
        }

    # ---------------------------------------------------------- plumbing

    def applies(self, cls) -> bool:
        """The engine covers the exact-GP family fitted by `fit_gp_batch`
        (gpr, egp, rbf and subclasses); MEGP's shared fit and anything
        else take the plain constructor, as in the reference."""
        from dmosopt_tpu_torch.models.gp import GPR_Matern

        return isinstance(cls, type) and issubclass(cls, GPR_Matern)

    def note_unsupported(self, cls):
        if not self._unsupported_warned and self.logger is not None:
            self.logger.info(
                f"surrogate_refit: {getattr(cls, '__name__', cls)!r} is outside "
                f"the exact-GP warm-refit family; fitting cold"
            )
        self._unsupported_warned = True

    def _record(self, sm):
        """Snapshot a converged fit: host hyperparameter vectors and the
        model itself (its factor feeds the next rank-k extension)."""
        from dmosopt_tpu_torch.models import gp

        fit = sm.fit
        self._model = sm
        amp = _host(fit.amp)
        noise = _host(fit.noise)
        rel_jitter = getattr(sm, "_rel_jitter", None)
        if rel_jitter is None:
            rel_jitter = gp._default_rel_jitter(fit.X.dtype)
        self._hyper = {
            "amp": amp,
            "ls": _host(fit.ls),
            "noise": noise,
            # the diagonal the kernel carries (gp._regularized_kernel)
            "eff_noise": noise + gp._JITTER + rel_jitter * amp,
        }
        self._y_mean = _host(fit.y_mean)
        self._y_std = _host(fit.y_std)
        self._n_train = int(np.sum(_host(fit.train_mask) > 0.0))
        # the steps-saved baseline is the cold budget
        self._n_iter_max = max(
            self._n_iter_max,
            int((getattr(sm, "fit_info", None) or {}).get("n_iter_max", 0)),
        )

    def _emit(self, telemetry, info, path, **fields):
        self.last_path = path
        self.path_history.append(path)
        if info is not None:
            info["refit_path"] = path
        if telemetry:
            telemetry.event("surrogate_refit", path=path, **fields)

    # ------------------------------------------------------------- paths

    def fit(self, builder, xin, yin, *, nan="remove", top_k=None,
            telemetry=None, info=None):
        """Fit (or update) the surrogate for this epoch's training set.
        ``builder(**overrides)`` constructs the surrogate class with the
        epoch's keyword arguments; ``xin``/``yin`` are the rows `train`
        hands the constructor."""
        cfg = self.config
        if self._hyper is None:
            sm = builder()
            self._record(sm)
            self._fits_since_audit = 0
            self._emit(telemetry, info, "cold", n_train=self._n_train,
                       n_steps=sm.fit_info.get("n_steps"))
            return sm

        if self._fits_since_audit >= cfg.audit_every:
            return self._fit_audit(builder, telemetry, info)

        if self._stable >= cfg.rank_update_after and self._model is not None:
            sm = self._try_rank_update(xin, yin, nan, top_k, telemetry, info)
            if sm is not None:
                return sm
            # not an append of the cached set: fall through to warm

        return self._fit_warm(builder, telemetry, info)

    def _fit_audit(self, builder, telemetry, info):
        """Full-restart cold fit; resets the stability and pruning
        schedule."""
        prev_hyper = self._hyper
        sm = builder()
        self._record(sm)
        movement = _hyper_movement(prev_hyper, self._hyper)
        self._fits_since_audit = 0
        self._stable = 0
        self._warm_wins = 0
        if telemetry:
            telemetry.inc("gp_refit_audits_total")
        self._emit(telemetry, info, "audit", n_train=self._n_train,
                   movement=round(movement["mean"], 6),
                   movement_amp=round(movement["amp"], 6),
                   n_steps=sm.fit_info.get("n_steps"))
        if self.logger is not None:
            self.logger.info(
                f"surrogate_refit: audit fit moved hyperparameters by "
                f"{movement['mean']:.4f} (mean-shaping) / "
                f"{movement['amp']:.4f} (amp), log-space max"
            )
        return sm

    def _fit_warm(self, builder, telemetry, info):
        cfg = self.config
        prev_hyper = self._hyper
        pruned = self._warm_wins >= cfg.prune_after
        overrides: Dict[str, Any] = {
            "warm_start": (prev_hyper["amp"], prev_hyper["ls"], prev_hyper["noise"])
        }
        if pruned:
            overrides["n_starts"] = cfg.pruned_starts
        if cfg.warm_iter_cap is not None and self._n_iter_max > 0:
            overrides["n_iter"] = max(1, int(round(self._n_iter_max * cfg.warm_iter_cap)))
        try:
            sm = builder(**overrides)
        except ValueError as e:
            # e.g. a resumed run whose surrogate configuration changed
            # shape: the state is unusable, refit cold and start over
            if self.logger is not None:
                self.logger.warning(
                    f"surrogate_refit: warm state unusable ({e}); refitting cold"
                )
            sm = builder()
            self._record(sm)
            self._fits_since_audit = 0
            self._stable = 0
            self._warm_wins = 0
            self._emit(telemetry, info, "cold", n_train=self._n_train,
                       n_steps=sm.fit_info.get("n_steps"))
            return sm
        base_iter = self._n_iter_max
        self._record(sm)
        self._fits_since_audit += 1

        movement = _hyper_movement(prev_hyper, self._hyper)
        stable = movement["mean"] <= cfg.hyper_tol and movement["amp"] <= cfg.amp_tol
        self._stable = self._stable + 1 if stable else 0
        best_start = sm.fit.best_start
        warm_won = best_start is not None and bool(torch.all(best_start == 0))
        self._warm_wins = self._warm_wins + 1 if warm_won else 0

        n_steps = int(sm.fit_info.get("n_steps", 0))
        if telemetry:
            telemetry.inc("gp_warm_starts_total")
            telemetry.inc("gp_refit_steps_saved_total", max(base_iter - n_steps, 0))
        self._emit(telemetry, info, "warm", n_train=self._n_train,
                   movement=round(movement["mean"], 6),
                   movement_amp=round(movement["amp"], 6),
                   warm_won=warm_won, pruned=pruned, n_steps=n_steps)
        return sm

    def _try_rank_update(self, xin, yin, nan, top_k, telemetry, info):
        """Extend the cached posterior for appended rows; None when the
        new training set is not an append-only extension of the cached
        one (the caller then refits warm)."""
        from dmosopt_tpu_torch.models import gp

        prev = self._model

        class _Holder:  # _prepare_training_data writes the bounds here
            pass

        X, Yn, _, _ = gp._prepare_training_data(
            _Holder(), xin, yin, prev.nInput, prev.nOutput, prev.xlb, prev.xub,
            nan, top_k, y_stats=(self._y_mean, self._y_std),
        )
        n_new, n_old = X.shape[0], self._n_train
        if n_new < n_old:
            return None
        prev_X = prev._host_X()
        dt_np = prev_X.dtype
        X_cast = np.asarray(X, dtype=dt_np)
        if not np.array_equal(X_cast[:n_old], prev_X[:n_old]):
            return None  # rows were reordered or dropped: not an append
        k = n_new - n_old
        d = int(prev.nOutput)
        n_iter_max = self._n_iter_max  # the cold budget, all of it saved
        if k == 0:
            # dedupe swallowed the whole batch: the cached posterior is
            # already exact for this training set
            self._fits_since_audit += 1
            if telemetry:
                telemetry.inc("gp_rank_updates_total")
                telemetry.inc("gp_refit_steps_saved_total", n_iter_max)
            self._emit(telemetry, info, "rank", n_train=n_old, rank_rows=0)
            return prev

        dev, dt = prev.fit.X.device, prev.fit.X.dtype
        P = prev_X.shape[0]
        rel_jitter = prev._rel_jitter
        if rel_jitter is None:
            rel_jitter = gp._default_rel_jitter(dt)
        on_dev = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        if n_new <= P:
            # in-bucket append: blocked rank-k update of the cached factor
            X_pad = prev_X.copy()
            X_pad[n_old:n_new] = X_cast[n_old:n_new]
            mask = (np.arange(P) < n_new).astype(dt_np)
            Yn_pad = np.zeros((P, d), dtype=dt_np)
            Yn_pad[:n_new] = np.asarray(Yn, dtype=dt_np)
            L, alpha, nmll = gp.extend_cholesky_rank_k(
                prev.fit.L, on_dev(X_pad), on_dev(mask), on_dev(Yn_pad),
                prev.fit.amp, prev.fit.ls, prev.fit.noise, kernel=prev.kernel,
                n_old=n_old, n_new=n_new, rel_jitter=rel_jitter,
            )
            path = "rank"
        else:
            # bucket boundary crossed: re-pad and refactorize at the fixed
            # hyperparameters (no Adam)
            X_pad, Yn_pad, mask = gp._pad_to_bucket(X_cast, np.asarray(Yn, dtype=dt_np))
            mask = mask.astype(dt_np)
            L, alpha, nmll = gp.posterior_from_params(
                on_dev(X_pad), on_dev(Yn_pad), on_dev(mask),
                prev.fit.amp, prev.fit.ls, prev.fit.noise,
                kernel=prev.kernel, rel_jitter=rel_jitter,
            )
            path = "rank_refactor"
        # a carried-over W = L⁻¹ is tied to the old factor: dropped
        fit = dataclasses.replace(
            prev.fit, X=on_dev(X_pad), L=L, alpha=alpha, nmll=nmll,
            train_mask=on_dev(mask), n_steps=0, whitened=None,
        )

        nmll_np = _host(nmll)
        fit_info = {
            "loss": float(np.mean(nmll_np)),
            "nmll_per_objective": [float(v) for v in nmll_np],
            "n_steps": 0,
            "n_iter_max": n_iter_max,
            "early_stopped": True,
            "refit_path": path,
            "rank_rows": int(k),
        }
        sm = gp.clone_with_fit(prev, fit, fit_info)
        sm._X_host = X_pad
        # the previous predictor belongs to the old posterior: an
        # in-bucket append extends a built matmul cache; anything else
        # leaves the clone without one, and `moasmo.train`'s eager
        # build_predictor() rebuilds it
        prev_pred = prev._predictor_obj
        if prev_pred is not None and path == "rank":
            sm._predictor_obj = prev_pred.after_rank_update(fit, n_old=n_old, n_new=n_new)
        self._model = sm
        self._n_train = n_new
        self._fits_since_audit += 1
        if telemetry:
            telemetry.inc("gp_rank_updates_total")
            telemetry.inc("gp_rank_update_rows_total", k)
            telemetry.inc("gp_refit_steps_saved_total", n_iter_max)
        self._emit(telemetry, info, path, n_train=n_new, rank_rows=int(k))
        return sm
