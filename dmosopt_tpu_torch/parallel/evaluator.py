"""Objective-evaluation backends.

Port of ``dmosopt_tpu/parallel/evaluator.py`` for this slice: the inline
host-function evaluator (`HostFunEvaluator` :384, with one worker) and
the batched device objective (`TorchBatchEvaluator`, the counterpart of
`JaxBatchEvaluator` :550, ``jax_objective=True`` there and
``torch_objective=True`` here). Both return the reference worker
protocol, ``{problem_id: result, "time": seconds}`` per request. Thread
pools, asynchronous submission, timeouts and retries are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch


class HostFunEvaluator:
    """Evaluate host-Python objectives inline, one call per request.

    ``eval_fun(space_vals_dict) -> {problem_id: result, "time": t}`` is
    the per-problem objective wrapper the driver builds."""

    def __init__(self, eval_fun: Callable):
        self.eval_fun = eval_fun

    def evaluate_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]]
    ) -> List[Dict]:
        return [self.eval_fun(sv) for sv in space_vals_list]


class TorchBatchEvaluator:
    """Evaluate a batched torch objective in one call per batch (one
    problem, id 0).

    ``batch_fun`` maps a (B, n) float32 tensor of flat parameter vectors
    on ``device`` to objectives (B, d) on any device."""

    def __init__(self, batch_fun: Callable, device):
        self.batch_fun = batch_fun
        self.device = torch.device(device)

    def evaluate_batch(
        self, space_vals_list: Sequence[Dict[Any, np.ndarray]]
    ) -> List[Dict]:
        if not space_vals_list:
            return []
        t0 = time.time()
        X = np.stack([sv[0] for sv in space_vals_list])
        Y = self.batch_fun(torch.as_tensor(X, dtype=torch.float32, device=self.device))
        Y = Y.detach().cpu().numpy()
        dt = (time.time() - t0) / len(space_vals_list)
        return [{0: y, "time": dt} for y in Y]
