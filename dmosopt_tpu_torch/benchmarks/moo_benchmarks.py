"""Many-objective benchmark suite: DTLZ, WFG, MaF, batched.

Port of ``dmosopt_tpu/benchmarks/moo_benchmarks.py`` (after reference
`dmosopt/benchmarks/moo_benchmarks.py`): DTLZ1-5,7, WFG1/WFG4, MaF1/2/4,
`generate_problem_space`, `get_problem` and the problem metadata. Every
problem maps a ``(B, n)`` float32 tensor to ``(B, m)`` objectives on the
tensor's own device, with cumulative-product shape math, so it serves
as a batched torch objective (``torch_objective=True``). Single points
``(n,)`` are promoted to a batch of one; numpy input becomes a CPU
tensor.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch

_PI = math.pi


def _as_batch(x):
    x = torch.as_tensor(x, dtype=torch.float32)
    single = x.dim() == 1
    return (x[None, :], True) if single else (x, False)


def _unbatch(f, single):
    return f[0] if single else f


def _shape_products(cos_terms, sin_terms, n_obj):
    """Generic DTLZ-style shape: f_i = prod_{j < m-1-i} cos_j * sin_{m-1-i}
    (sin term absent for i = 0). cos/sin terms are (B, m-1) tensors.
    Returns (B, m) WITHOUT the (1+g) factor."""
    B = cos_terms.shape[0]
    ones = torch.ones((B, 1), dtype=cos_terms.dtype, device=cos_terms.device)
    # cp[:, t] = prod_{j < t} cos_j, t = 0..m-1
    cp = torch.cat([ones, torch.cumprod(cos_terms, dim=1)], dim=1)
    cols = []
    for i in range(n_obj):
        t = n_obj - 1 - i
        col = cp[:, t]
        if i > 0:
            col = col * sin_terms[:, t]
        cols.append(col)
    return torch.stack(cols, dim=1)


def _g_rastrigin(xm):
    k = xm.shape[1]
    return 100.0 * (
        k + torch.sum((xm - 0.5) ** 2 - torch.cos(20.0 * _PI * (xm - 0.5)), dim=1)
    )


def _g_sphere(xm):
    return torch.sum((xm - 0.5) ** 2, dim=1)


def dtlz1(x, n_obj: int = 3):
    """Linear PF (sum f_i = 0.5), multi-modal g (reference :21-56)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_rastrigin(x[:, m - 1 :])
    y = x[:, : m - 1]
    f = 0.5 * _shape_products(y, 1.0 - y, m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def dtlz2(x, n_obj: int = 3):
    """Spherical concave PF (reference :59-94)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_sphere(x[:, m - 1 :])
    a = x[:, : m - 1] * (_PI / 2.0)
    f = _shape_products(torch.cos(a), torch.sin(a), m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def dtlz3(x, n_obj: int = 3):
    """DTLZ2 shape with the multi-modal g (reference :97-133)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_rastrigin(x[:, m - 1 :])
    a = x[:, : m - 1] * (_PI / 2.0)
    f = _shape_products(torch.cos(a), torch.sin(a), m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def dtlz4(x, n_obj: int = 3, alpha: float = 100.0):
    """Biased spherical PF via x^alpha (reference :136-171)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_sphere(x[:, m - 1 :])
    a = (x[:, : m - 1] ** alpha) * (_PI / 2.0)
    f = _shape_products(torch.cos(a), torch.sin(a), m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def dtlz5(x, n_obj: int = 3):
    """Degenerate curve PF (reference :174-215)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_sphere(x[:, m - 1 :])
    theta0 = x[:, :1] * (_PI / 2.0)
    rest = (1.0 + 2.0 * g[:, None] * x[:, 1 : m - 1]) / (
        2.0 * (1.0 + g[:, None])
    ) * (_PI / 2.0)
    theta = torch.cat([theta0, rest], dim=1)
    f = _shape_products(torch.cos(theta), torch.sin(theta), m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def dtlz7(x, n_obj: int = 3):
    """Disconnected PF (reference :218-259)."""
    x, single = _as_batch(x)
    m = n_obj
    g = 1.0 + 9.0 * torch.mean(x[:, m - 1 :], dim=1)
    f_head = x[:, : m - 1]
    h = m - torch.sum(
        f_head / (1.0 + g[:, None]) * (1.0 + torch.sin(3.0 * _PI * f_head)),
        dim=1,
    )
    f_last = (1.0 + g) * h
    f = torch.cat([f_head, f_last[:, None]], dim=1)
    return _unbatch(f, single)


# ------------------------------------------------------------------- WFG


def _block(i: int, ll: int, n_var: int) -> slice:
    """Shape-vector block i of width `ll`, clamped non-empty. The reference
    slices `t[i*ll:(i+1)*ll]` unguarded and crashes on empty blocks for
    n_obj >= 4 with its own default n_var (moo_benchmarks.py:326); here
    out-of-range blocks fall back to the trailing `ll` columns."""
    start = i * ll
    if start >= n_var:
        return slice(n_var - ll, n_var)
    return slice(start, min(start + ll, n_var))


def wfg_shape_linear(xv, m: int):
    """Linear WFG shape over the (B, m) shape vector (reference :262-271)."""
    return _shape_products(xv[:, : m - 1], 1.0 - xv[:, : m - 1], m)


def wfg_shape_convex(xv, m: int):
    """Convex WFG shape over the (B, m) shape vector (reference :274-283),
    in the half-angle forms 1-cos(t) = 2 sin^2(t/2) and
    1-sin(t) = 2 sin^2(pi/4 - t/2), which are free of cancellation in
    float32."""
    t = xv[:, : m - 1] * (_PI / 2.0)
    c = 2.0 * torch.sin(t / 2.0) ** 2
    s = 2.0 * torch.sin(_PI / 4.0 - t / 2.0) ** 2
    return _shape_products(c, s, m)


def _arange1(n, x):
    """1, 2, ..., n as floats on ``x``'s device."""
    return torch.arange(1, n + 1, dtype=x.dtype, device=x.device)


def wfg1(x, n_obj: int = 3, k: Optional[int] = None):
    """Mixed-separability, biased/flat transformations (reference :286-333).
    Bounds: x_i in [0, 2i]."""
    x, single = _as_batch(x)
    n_var = x.shape[1]
    if k is None:
        k = n_obj - 1
    ll = n_var - k
    y = x / (2.0 * _arange1(n_var, x))
    t1 = torch.cat([y[:, :k], y[:, k:] ** 0.02], dim=1)
    t2 = torch.cat([t1[:, :k], 0.35 + 0.65 * t1[:, k:]], dim=1)
    xv_cols = [
        torch.amax(t2[:, _block(i, ll, n_var)], dim=1) for i in range(n_obj - 1)
    ]
    xv_cols.append(torch.mean(t2[:, -ll:], dim=1))
    xv = torch.stack(xv_cols, dim=1)
    f = wfg_shape_convex(xv, n_obj) * (1.0 + _arange1(n_obj, x))
    return _unbatch(f, single)


def wfg4(x, n_obj: int = 3, k: Optional[int] = None):
    """Multi-modal transformation, concave shape (reference :335-381)."""
    x, single = _as_batch(x)
    n_var = x.shape[1]
    if k is None:
        k = n_obj - 1
    ll = n_var - k
    y = x / (2.0 * _arange1(n_var, x))
    t1 = y + 0.35 - 0.15 * torch.cos(10.0 * _PI * y - 5.0)
    xv_cols = [
        torch.mean(t1[:, _block(i, ll, n_var)], dim=1) for i in range(n_obj - 1)
    ]
    xv_cols.append(torch.mean(t1[:, -ll:], dim=1))
    xv = torch.stack(xv_cols, dim=1)
    f = wfg_shape_convex(xv, n_obj) * (1.0 + _arange1(n_obj, x))
    return _unbatch(f, single)


# ------------------------------------------------------------------- MaF


def maf1(x, n_obj: int = 5):
    """Linear PF, complex PS (reference :384-419)."""
    x, single = _as_batch(x)
    m = n_obj
    xm = x[:, m - 1 :]
    g = torch.sum((xm - 0.5) ** 2 - torch.cos(20.0 * _PI * (xm - 0.5)), dim=1)
    y = x[:, : m - 1]
    f = _shape_products(y, 1.0 - y, m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def maf2(x, n_obj: int = 5):
    """Concave PF for many objectives (reference :422-457)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_sphere(x[:, m - 1 :])
    a = x[:, : m - 1] * (_PI / 2.0)
    f = _shape_products(torch.cos(a), torch.sin(a), m) * (1.0 + g)[:, None]
    return _unbatch(f, single)


def maf4(x, n_obj: int = 5):
    """Badly-scaled concave PF: objective i scaled by 100^i
    (reference :460-502)."""
    x, single = _as_batch(x)
    m = n_obj
    g = _g_sphere(x[:, m - 1 :])
    a = x[:, : m - 1] * (_PI / 2.0)
    f = _shape_products(torch.cos(a), torch.sin(a), m) * (1.0 + g)[:, None]
    scales = 10.0 ** (2.0 * torch.arange(m, dtype=x.dtype, device=x.device))
    f = f * scales[None, :]
    return _unbatch(f, single)


PROBLEMS = {
    "dtlz1": dtlz1,
    "dtlz2": dtlz2,
    "dtlz3": dtlz3,
    "dtlz4": dtlz4,
    "dtlz5": dtlz5,
    "dtlz7": dtlz7,
    "wfg1": wfg1,
    "wfg4": wfg4,
    "maf1": maf1,
    "maf2": maf2,
    "maf4": maf4,
}


def get_problem(problem_name: str, n_obj: int):
    """Batched objective `f(x) -> (B, n_obj)` for a named problem."""
    return partial(PROBLEMS[problem_name], n_obj=n_obj)


def generate_problem_space(
    problem_name: str, n_obj: int, n_var: Optional[int] = None
) -> dict:
    """dmosopt-style parameter space dict (reference :505-556)."""
    if n_var is None:
        if problem_name.startswith("dtlz"):
            if problem_name in ("dtlz1", "dtlz3"):
                n_var = n_obj + 4
            elif problem_name == "dtlz7":
                n_var = n_obj + 19
            else:
                n_var = n_obj + 9
        elif problem_name.startswith("wfg"):
            n_var = n_obj - 1 + 10
        elif problem_name.startswith("maf"):
            n_var = n_obj + 9
        else:
            n_var = n_obj + 10

    if problem_name.startswith("wfg"):
        return {f"x{i + 1}": [0.0, 2.0 * (i + 1)] for i in range(n_var)}
    return {f"x{i + 1}": [0.0, 1.0] for i in range(n_var)}


_METADATA = {
    "dtlz1": dict(difficulty="medium", pf_shape="linear", multi_modal=True,
                  expected_overlap_ratio="low", standard_n_obj_range=(3, 15),
                  tests_features=["multi_modality", "false_convergence"]),
    "dtlz2": dict(difficulty="easy", pf_shape="concave", multi_modal=False,
                  expected_overlap_ratio="high", standard_n_obj_range=(3, 30),
                  tests_features=["spherical_front", "clean_convergence"]),
    "dtlz3": dict(difficulty="very_hard", pf_shape="concave", multi_modal=True,
                  expected_overlap_ratio="high", standard_n_obj_range=(3, 10),
                  tests_features=["extreme_multi_modality"]),
    "dtlz4": dict(difficulty="medium", pf_shape="concave", multi_modal=False,
                  expected_overlap_ratio="high", standard_n_obj_range=(3, 15),
                  tests_features=["biased_density", "diversity"]),
    "dtlz5": dict(difficulty="medium", pf_shape="degenerate", multi_modal=False,
                  expected_overlap_ratio="low", standard_n_obj_range=(3, 10),
                  tests_features=["degenerate_front"]),
    "dtlz7": dict(difficulty="hard", pf_shape="disconnected", multi_modal=False,
                  expected_overlap_ratio="medium", standard_n_obj_range=(3, 10),
                  tests_features=["disconnected_regions", "adaptive_window"]),
    "wfg1": dict(difficulty="hard", pf_shape="mixed", multi_modal=False,
                 expected_overlap_ratio="medium", standard_n_obj_range=(3, 10),
                 tests_features=["bias", "flat_regions", "per_objective"]),
    "wfg4": dict(difficulty="hard", pf_shape="concave", multi_modal=True,
                 expected_overlap_ratio="high", standard_n_obj_range=(3, 10),
                 tests_features=["multi_modality"]),
    "maf1": dict(difficulty="medium", pf_shape="linear", multi_modal=True,
                 expected_overlap_ratio="low", standard_n_obj_range=(5, 30),
                 tests_features=["many_objective", "linear_front"]),
    "maf2": dict(difficulty="easy", pf_shape="concave", multi_modal=False,
                 expected_overlap_ratio="high", standard_n_obj_range=(5, 15),
                 tests_features=["many_objective_baseline"]),
    "maf4": dict(difficulty="hard", pf_shape="concave", multi_modal=False,
                 expected_overlap_ratio="high", standard_n_obj_range=(5, 15),
                 tests_features=["badly_scaled", "reference_point_adaptation"]),
}


def get_problem_metadata(problem_name: str, n_obj: int) -> dict:
    """Problem characteristics for test harnesses (reference :557-750)."""
    meta = dict(_METADATA[problem_name])
    lo, hi = meta["standard_n_obj_range"]
    meta["n_obj_in_standard_range"] = lo <= n_obj <= hi
    return meta
