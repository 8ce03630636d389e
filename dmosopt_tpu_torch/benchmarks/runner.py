"""End-to-end benchmark capture harness.

Port of ``dmosopt_tpu/benchmarks/runner.py``: run a MO-ASMO optimization
per DTLZ/WFG/MaF problem and record final hypervolume, per-epoch HV
trajectory, wall-clock, and termination reason to JSON, with the JAX
package's fields, defaults, tiers and file names.

The benchmark objectives are batched torch functions
(`benchmarks.moo_benchmarks`), so evaluation goes through the
``torch_objective`` path (one call per resample batch on the runner's
device) where the JAX package passes ``jax_objective``. The runner drives
``run_epoch`` itself, so the HV trajectory is measured (one
``AdaptiveHyperVolume`` evaluation of the archive per epoch, its
estimators on the runner's device). ``device=None`` means CUDA, and
raises without a CUDA device.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from dmosopt_tpu_torch import driver
from dmosopt_tpu_torch.benchmarks.moo_benchmarks import (
    generate_problem_space,
    get_problem,
    get_problem_metadata,
)
from dmosopt_tpu_torch.hv import AdaptiveHyperVolume, default_reference_point
from dmosopt_tpu_torch.utils import json_default
from dmosopt_tpu_torch.utils.device import resolve_device


@dataclass
class BenchmarkResult:
    """Diagnostics from one benchmark optimization run
    (reference tests/test_moo_benchmarks.py:25-48)."""

    problem_name: str
    n_objectives: int
    n_variables: int
    converged: bool
    final_epoch: int
    final_hv: float
    computation_time_seconds: float
    termination_reason: str
    hv_trajectory: List[float] = field(default_factory=list)
    hv_method: str = ""
    hv_ci: float = 0.0
    n_archive: int = 0
    metadata: Dict = field(default_factory=dict)


class BenchmarkRunner:
    """Run benchmark problems through the full MO-ASMO loop on
    ``device`` and capture per-problem diagnostics to
    ``<output_dir>/<problem>_m<d>_result.json``."""

    def __init__(self, output_dir: str = "benchmark_results", mesh=None,
                 device=None):
        self.device = resolve_device(device)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.results: List[BenchmarkResult] = []

    # ------------------------------------------------------------- single

    def run_single_benchmark(
        self,
        problem_name: str,
        n_obj: int,
        n_var: Optional[int] = None,
        population_size: int = 64,
        num_generations: int = 50,
        n_epochs: int = 4,
        n_initial: int = 8,
        surrogate_method_name: Optional[str] = "gpr",
        surrogate_method_kwargs: Optional[dict] = None,
        optimizer_name="age",
        termination_conditions=None,
        hv_epsilon: Optional[float] = 0.05,
        random_seed: int = 42,
        save_json: bool = True,
        verbose: bool = False,
    ) -> BenchmarkResult:
        space = generate_problem_space(problem_name, n_obj, n_var=n_var)
        # the problem definitions are batch maps over their own native
        # domains, which the space dict already encodes (WFG's
        # per-dimension [0, 2i] included) — the driver hands the objective
        # raw (B, n) parameter batches
        objective = get_problem(problem_name, n_obj)

        params = {
            "opt_id": f"{problem_name}_m{n_obj}",
            "obj_fun": objective,
            "torch_objective": True,
            "objective_names": [f"f{i + 1}" for i in range(n_obj)],
            "space": space,
            "problem_parameters": {},
            "n_initial": n_initial,
            "n_epochs": n_epochs,
            "population_size": population_size,
            "num_generations": num_generations,
            "resample_fraction": 0.25,
            "optimizer_name": optimizer_name,
            "surrogate_method_name": surrogate_method_name,
            "surrogate_method_kwargs": surrogate_method_kwargs
            or {"n_starts": 4, "n_iter": 100, "seed": 0},
            "termination_conditions": termination_conditions,
            "random_seed": random_seed,
            "mesh": self.mesh,
            "device": self.device,
        }

        t0 = time.time()
        dopt = driver.dopt_init(params, verbose=verbose, initialize_strategy=True)

        # drive epochs by hand so the HV trajectory is measured per epoch
        hv_engine: Optional[AdaptiveHyperVolume] = None
        hv_trajectory: List[float] = []
        while dopt.epoch_count < dopt.n_epochs:
            dopt.run_epoch()
            y = dopt.optimizer_dict[0].y
            if y is None or y.shape[0] == 0:
                hv_trajectory.append(0.0)
                continue
            if hv_engine is None:
                # nadir-anchored, span-margined reference point, fixed
                # across the run so the trajectory is comparable epoch to
                # epoch (valid for objectives of any sign)
                hv_engine = AdaptiveHyperVolume(
                    default_reference_point(y), epsilon=hv_epsilon,
                    device=self.device,
                )
            hv_trajectory.append(float(hv_engine.compute_hypervolume(y)))
        elapsed = time.time() - t0

        strategy = dopt.optimizer_dict[0]
        # report which criterion actually fired (the epoch budget always
        # ends the outer loop; `stop_reasons` says what ended the inner
        # ones). "Converged" means a quality/stagnation criterion fired,
        # not merely that a generation cap was hit.
        fired = (
            strategy.termination.stop_reasons()
            if strategy.termination is not None
            else []
        )
        reason = "+".join(fired) if fired else "epoch_budget"
        converged = any(r != "MaximumGenerationTermination" for r in fired)

        final_hv = hv_trajectory[-1] if hv_trajectory else 0.0
        result = BenchmarkResult(
            problem_name=problem_name,
            n_objectives=n_obj,
            n_variables=len(space),
            converged=converged,
            final_epoch=int(dopt.epoch_count + dopt.start_epoch),
            final_hv=final_hv,
            computation_time_seconds=elapsed,
            termination_reason=reason,
            hv_trajectory=hv_trajectory,
            hv_method=hv_engine.last_method if hv_engine is not None else "",
            hv_ci=float(hv_engine.last_ci) if hv_engine is not None else 0.0,
            n_archive=int(strategy.y.shape[0]) if strategy.y is not None else 0,
            metadata=get_problem_metadata(problem_name, n_obj),
        )
        self.results.append(result)
        if save_json:
            self._save_result(result)
        return result

    # -------------------------------------------------------------- tiers

    TIERS = {
        1: [("dtlz2", 3), ("dtlz1", 3), ("dtlz7", 3), ("maf2", 5)],
        2: [("dtlz3", 3), ("dtlz5", 3), ("dtlz4", 5), ("maf4", 5)],
        3: [("maf1", 10), ("maf2", 10), ("maf2", 15)],
        4: [("wfg1", 3), ("wfg4", 3)],
    }

    def run_tier(self, tier: int = 1, **kwargs) -> List[BenchmarkResult]:
        return [
            self.run_single_benchmark(name, n_obj, **kwargs)
            for name, n_obj in self.TIERS[tier]
        ]

    # ---------------------------------------------------------------- io

    def _save_result(self, result: BenchmarkResult):
        path = (
            self.output_dir
            / f"{result.problem_name}_m{result.n_objectives}_result.json"
        )
        path.write_text(json.dumps(asdict(result), indent=2, default=json_default))

    def save_summary(self, filename: str = "summary.json"):
        (self.output_dir / filename).write_text(
            json.dumps([asdict(r) for r in self.results], indent=2,
                       default=json_default)
        )
