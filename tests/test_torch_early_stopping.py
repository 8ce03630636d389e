"""The port's early-stopping controller (`models/early_stopping.py`, a
copy of the JAX package's numpy module) against the JAX package's: the
same loss histories give the same stop decisions and reasons at every
check, the same `analyze_loss_trajectory` dicts and the same
`suggest_hyperparameters` advice, for every model type."""

import numpy as np
import pytest

from dmosopt_tpu.models import early_stopping as J
from dmosopt_tpu_torch.models import early_stopping as T


def _histories():
    """Loss histories of 1200 steps, seeded: converging, flat, plateau
    after a drop, oscillating, noisy around a slow decay, diverging."""
    rng = np.random.default_rng(11)
    t = np.arange(1200, dtype=np.float64)
    return {
        "converging": 50.0 * np.exp(-t / 80.0) + 1.5,
        "flat": np.full(1200, 1.2345),
        "plateau": np.where(t < 300, 10.0 - t / 40.0, 2.5) + 1e-5 * rng.normal(size=1200),
        "oscillating": 3.0 + np.sin(t / 3.0),
        "noisy": 20.0 * np.exp(-t / 400.0) + 0.05 * rng.normal(size=1200),
        "diverging": 1.0 + 1e-3 * t ** 1.5,
    }


HISTORIES = _histories()
CONFIGS = {
    **{f"{m.value}": m for m in J.ModelType},
    "small": dict(min_iterations=10, window_size=20, patience=2, threshold_pct=0.5,
                  absolute_tolerance=1e-3, warmup_iterations=10),
}


def _config(pkg, spec):
    if isinstance(spec, dict):
        return pkg.EarlyStoppingConfig(**spec)
    return pkg.EarlyStoppingConfig.for_model_type(pkg.ModelType(spec.value))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_stop_decisions_and_reasons_match_jax(history, config):
    """Checked every 25 steps as the deep GP's chunk loop would (every
    step for the small configuration), with a validation loss on every
    other check; both controllers see the same arrays."""
    h = HISTORIES[history].astype(np.float32)
    spec = CONFIGS[config]
    cj, ct = _config(J, spec), _config(T, spec)
    assert vars(cj) == vars(ct)
    sj, st = J.AdaptiveEarlyStopping(cj), T.AdaptiveEarlyStopping(ct)
    step = 1 if config == "small" else 25
    val = iter(np.linspace(5.0, 4.0, 2000))
    decisions = []
    for i, it in enumerate(range(step, len(h) + 1, step)):
        v = next(val) if i % 2 else None
        validation = (lambda v=v: v) if v is not None else None
        dj = sj.should_stop(it, h[:it], validation)
        dt = st.should_stop(it, h[:it], validation)
        assert dj == dt, (history, config, it)
        assert sj.patience_counter == st.patience_counter
        decisions.append(dj[0])
    if history == "flat":
        # the flat history trips at least the small configuration
        assert config != "small" or any(decisions)


@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_trajectory_analysis_and_advice_match_jax(history):
    """`analyze_loss_trajectory` on the whole history and on short
    prefixes (under the convergence window, and under 2 rows), then the
    advice of `suggest_hyperparameters` for each model type."""
    h = HISTORIES[history]
    for n in (1, 150, 700, len(h)):
        aj = J.analyze_loss_trajectory(h[:n])
        at = T.analyze_loss_trajectory(h[:n])
        assert aj == at, (history, n)
        for m in J.ModelType:
            assert J.suggest_hyperparameters(aj, m) == T.suggest_hyperparameters(
                at, T.ModelType(m.value)
            ), (history, n, m)
