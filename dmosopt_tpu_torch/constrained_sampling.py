"""Constrained parameter-space sampling with inter-parameter bound
expressions.

Port of ``dmosopt_tpu/constrained_sampling.py`` (reference
`dmosopt/constrained_sampling.py`): `ParamSpacePoints` samples a space
mixing unconstrained parameters (``[lo, hi]`` lists) and constrained
ones (dicts with absolute bounds, lower/upper bound *expressions* in
terms of other parameters, and a per-parameter sampling method
uniform/normal/percentile), or makes evolutionary children of a parent
population. The tokenizer, the recursive-descent parser, the dependency
resolution and the bounds are the JAX package's numpy code, copied; the
non-evolutionary designs come from the port's `sampling` module, so a
seed gives the JAX package's values bit for bit.

Children (`_get_children`) are made on the device: one SBX call and two
polynomial-mutation calls (`ops.variation.sbx` and `mutation`), which on
a CUDA tensor launch the standalone Triton kernels `launch_sbx` once and
`launch_mutation` twice. The draws (pair picks, operator bits, the SBX
and mutation uniforms; `children_draws`) are split from the arithmetic
(`children_core`), so a test can hand the JAX package's draws in.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from dmosopt_tpu_torch import sampling as sampling_mod
from dmosopt_tpu_torch.ops.variation import mutation, sbx
from dmosopt_tpu_torch.utils.device import resolve_device
from dmosopt_tpu_torch.utils.prng import as_generator, as_torch_generator


# ------------------------------------------------------- expression parser

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>[0-9]*\.?[0-9]+(?:[eE][-+]?\d+)?)"
    r"|(?P<id>[a-zA-Z_][a-zA-Z0-9_]*)"
    r"|(?P<op>\*\*|[-+*/()]))"
)


def tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"cannot tokenize {text[pos:]!r}")
        if m.group("num") is not None:
            tokens.append(("num", m.group("num")))
        elif m.group("id") is not None:
            name = m.group("id")
            if name.lower() in ("min", "max"):
                tokens.append(("minmax", name.lower()))
            else:
                tokens.append(("id", name))
        else:
            tokens.append(("op", m.group("op")))
        pos = m.end()
    return tokens


class BoundExpression:
    """Arithmetic over numbers and parameter names with ``+ - * / **``,
    parentheses, and infix ``min``/``max`` (the reference grammar,
    constrained_sampling.py:529-572). Evaluate with an environment of
    per-sample arrays."""

    def __init__(self, text: str):
        self.text = text
        self._tokens = tokenize(text)

    def variables(self) -> List[str]:
        return [v for t, v in self._tokens if t == "id"]

    def evaluate(self, env: Dict[str, np.ndarray]):
        tokens = list(self._tokens)
        pos = [0]

        def peek():
            return tokens[pos[0]] if pos[0] < len(tokens) else (None, None)

        def take():
            tok = tokens[pos[0]]
            pos[0] += 1
            return tok

        def atom():
            kind, val = peek()
            if kind == "op" and val == "(":
                take()
                out = expr()
                k, v = take()
                if v != ")":
                    raise ValueError(f"expected ')' in {self.text!r}")
                return out
            if kind == "op" and val in ("+", "-"):
                take()
                sub = atom()
                return sub if val == "+" else -sub
            if kind == "num":
                take()
                return float(val)
            if kind == "id":
                take()
                if val not in env:
                    raise KeyError(
                        f"unknown parameter {val!r} in expression {self.text!r}"
                    )
                return np.asarray(env[val])
            raise ValueError(f"unexpected token {val!r} in {self.text!r}")

        def power():
            base = atom()
            kind, val = peek()
            if kind == "op" and val == "**":
                take()
                return base ** power()
            return base

        def term():
            out = power()
            while True:
                kind, val = peek()
                if kind == "op" and val in ("*", "/"):
                    take()
                    rhs = power()
                    out = out * rhs if val == "*" else out / rhs
                elif kind == "minmax":
                    take()
                    rhs = power()
                    out = np.minimum(out, rhs) if val == "min" else np.maximum(out, rhs)
                else:
                    return out

        def expr():
            out = term()
            while True:
                kind, val = peek()
                if kind == "op" and val in ("+", "-"):
                    take()
                    rhs = term()
                    out = out + rhs if val == "+" else out - rhs
                else:
                    return out

        result = expr()
        if pos[0] != len(tokens):
            raise ValueError(f"trailing tokens in expression {self.text!r}")
        return result


# ------------------------------------------------------------- the sampler


class ParamSpacePoints:
    """Sample a parameter space with expression-constrained bounds
    (reference: dmosopt/constrained_sampling.py:12-463).

    Space entries: ``name: [lo, hi]`` (unconstrained) or
    ``name: {"abs": [lo, hi], "lb": [(param, "expr"), ...],
    "ub": [...], "method": ("uniform"|"normal"|"percentile", ...)}``.
    A dependency ``(param, "+ 5")`` bounds this parameter by
    ``param + 5`` (the expression is applied to the named parameter's
    sampled value); expressions may also reference parameters by name.
    Children of ``parents`` are made on ``device`` (None means CUDA).
    """

    def __init__(self, N, Space, Method=None, seed=None, parents=None, device=None):
        self.seed = seed
        self.device = device
        self.rng = as_generator(seed)
        self.N_params = int(N)
        self.Space = Space
        self.parents_dict = parents
        self._analyze()
        self.MethodUnc = Method
        self.SpaceUncMethod = Method or ("Evo" if parents is not None else "slh")
        self._generate()

    # -------------------------------------------------------------- setup

    def _analyze(self):
        self.param_keys = np.sort(list(self.Space.keys()))
        self.prm_idx_unc = np.array(
            [i for i, k in enumerate(self.param_keys) if isinstance(self.Space[k], list)],
            dtype=int,
        )
        self.prm_idx_con = np.array(
            [i for i, k in enumerate(self.param_keys) if isinstance(self.Space[k], dict)],
            dtype=int,
        )
        self.prm_unc_dim = len(self.prm_idx_unc)
        self.prm_con_dim = len(self.prm_idx_con)
        self.param_dim = self.prm_unc_dim + self.prm_con_dim
        self.unc_intervals = np.asarray(
            [self.Space[self.param_keys[i]] for i in self.prm_idx_unc], dtype=float
        ).reshape(self.prm_unc_dim, 2)

    # ----------------------------------------------------------- pipeline

    def _generate(self):
        self._generate_unconstrained()
        if self.prm_con_dim:
            self._generate_constrained()

    def _generate_unconstrained(self):
        self.param_arr = np.full((self.N_params, self.param_dim), np.nan)
        if self.prm_unc_dim == 0:
            return
        method = self.SpaceUncMethod
        if method == "Evo":
            X = self._get_children()
            self.N_params = X.shape[0]
            self.param_arr = np.full((self.N_params, self.param_dim), np.nan)
        elif callable(method):
            X = method(self.N_params, self.prm_unc_dim, self.rng)
            xlb, xub = self.unc_intervals[:, 0], self.unc_intervals[:, 1]
            X = X * (xub - xlb) + xlb
        else:
            fn = getattr(sampling_mod, method, None)
            if fn is None:
                raise RuntimeError(f"Unknown method {method}")
            X = np.asarray(fn(self.N_params, self.prm_unc_dim, self.rng))
            xlb, xub = self.unc_intervals[:, 0], self.unc_intervals[:, 1]
            X = X * (xub - xlb) + xlb
        self.param_arr[:, self.prm_idx_unc] = X

    # ---------------------------------------------- dependency resolution

    def _dependencies(self, key) -> List[str]:
        spec = self.Space[key]
        deps = []
        for side in ("lb", "ub"):
            for dep_param, expr in spec.get(side, []):
                deps.append(dep_param)
                deps.extend(BoundExpression(expr).variables())
        return deps

    def _resolution_order(self) -> List[str]:
        """Topological order of constrained parameters; iterates to a fixed
        point and raises on circular dependencies."""
        unc = set(self.param_keys[self.prm_idx_unc])
        remaining = {self.param_keys[i] for i in self.prm_idx_con}
        resolved = set(unc)
        order = []
        while remaining:
            progress = [
                k for k in sorted(remaining)
                if set(self._dependencies(k)) <= resolved
            ]
            if not progress:
                raise ValueError(
                    f"circular or unsatisfiable constraint dependencies "
                    f"among {sorted(remaining)}"
                )
            for k in progress:
                order.append(k)
                resolved.add(k)
                remaining.discard(k)
        return order

    # --------------------------------------------------------- constrained

    def _env(self) -> Dict[str, np.ndarray]:
        return {
            self.param_keys[i]: self.param_arr[:, i]
            for i in range(self.param_dim)
            if not np.all(np.isnan(self.param_arr[:, i]))
        }

    def _bounds_from_relations(self, relations, lower: bool):
        """Per-sample bound from dependency relations: the max of lower
        candidates / min of upper candidates (reference :357-365)."""
        env = self._env()
        cands = []
        for dep_param, expr in relations:
            if dep_param not in env:
                raise KeyError(f"dependency {dep_param!r} not yet sampled")
            base = env[dep_param]
            # the reference splices the value in front of the expression;
            # an expression starting with an operator continues from `base`
            text = expr.strip()
            if text and text[0] in "+-*/" or text[:2] == "**":
                vals = BoundExpression(f"__base__ {text}").evaluate(
                    {**env, "__base__": base}
                )
            else:
                vals = BoundExpression(text).evaluate(env)
            cands.append(np.broadcast_to(np.asarray(vals, float), (self.N_params,)))
        stacked = np.stack(cands, axis=1)
        return stacked.max(axis=1) if lower else stacked.min(axis=1)

    def _solve_bounds(self, spec) -> Tuple[np.ndarray, np.ndarray]:
        absbnds = spec.get("abs")
        lb = ub = None
        if spec.get("lb"):
            lb = self._bounds_from_relations(spec["lb"], lower=True)
        if spec.get("ub"):
            ub = self._bounds_from_relations(spec["ub"], lower=False)

        if absbnds is None:
            if lb is None or ub is None:
                raise KeyError(
                    "Constrained parameter requires both lower and upper "
                    "bounds when absolute bounds are not specified."
                )
        else:
            if lb is None:
                lb = np.full(self.N_params, float(absbnds[0]))
            if ub is None:
                ub = np.full(self.N_params, float(absbnds[1]))
            # overconstrained samples fall back to the absolute range
            # (reference :409-425)
            invalid = lb >= ub
            if invalid.any():
                lb = np.where(invalid, float(absbnds[0]), lb)
                ub = np.where(invalid, float(absbnds[1]), ub)
            if spec.get("clip_abs", True):
                lb = np.clip(lb, float(absbnds[0]), float(absbnds[1]))
                ub = np.clip(ub, float(absbnds[0]), float(absbnds[1]))
        return lb, ub

    def _sample_values(self, lb, ub, method) -> np.ndarray:
        """Per-sample draw within [lb, ub] (reference :449-463)."""
        if isinstance(method, str):
            method = (method,)
        name = method[0]
        args = list(method[1:])
        mid = 0.5 * (lb + ub)
        span = ub - lb
        if name == "uniform":
            return self.rng.uniform(lb, ub)
        if name == "normal":
            mu = args[0] if len(args) > 0 and args[0] is not None else 0.0
            kappa = args[1] if len(args) > 1 and args[1] is not None else 1.0
            off = 0.5 * self.rng.vonmises(mu, kappa, size=self.N_params) / np.pi
            return mid + off * span
        if name == "percentile":
            if not args:
                raise ValueError("percentile method requires a fraction argument")
            return lb + float(args[0]) * span
        raise ValueError(f"unknown sampling method {name!r}")

    def _generate_constrained(self):
        for key in self._resolution_order():
            spec = self.Space[key]
            lb, ub = self._solve_bounds(spec)
            vals = self._sample_values(lb, ub, spec.get("method", ("uniform",)))
            kidx = int(np.searchsorted(self.param_keys, key))
            self.param_arr[:, kidx] = vals

    # ------------------------------------------------------- evolutionary

    def _get_children(self) -> np.ndarray:
        """SBX/mutation children of a parent population over the
        unconstrained dimensions (reference :117-225), made on the
        device; the numpy stream gives the torch generator one draw, as
        the JAX package's key takes one."""
        p = dict(self.parents_dict)
        params = np.asarray(p["params"])
        values = np.asarray(p["values"], dtype=np.float32)
        unc_keys = self.param_keys[self.prm_idx_unc]
        if not np.isin(unc_keys, params).all():
            raise ValueError("Missing unconstrained params from parents")
        col = [int(np.where(params == k)[0][0]) for k in unc_keys]
        unc_values = values[:, col]

        pop_size = int(p.get("pop_size", unc_values.shape[0]))
        n_children = int(p.get("n_children", self.N_params))
        crossover_rate = float(p.get("crossover_rate", 0.9))
        di_crossover = np.asarray(p.get("di_crossover", 1.0), dtype=np.float32)
        di_mutation = np.asarray(p.get("di_mutation", 20.0), dtype=np.float32)
        mutation_rate = p.get("mutation_rate", 1.0 / self.prm_unc_dim)
        xlb = self.unc_intervals[:, 0].astype(np.float32)
        xub = self.unc_intervals[:, 1].astype(np.float32)
        n = self.prm_unc_dim

        dev = resolve_device(self.device)
        generator = as_torch_generator(self.rng, dev)
        npairs = max(n_children // 2, 1)
        P = min(pop_size, unc_values.shape[0])
        draws = children_draws(generator, npairs, P, n, crossover_rate, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        X = children_core(
            torch.as_tensor(unc_values, device=dev), draws,
            torch.broadcast_to(torch.as_tensor(di_crossover, **f32), (n,)),
            torch.broadcast_to(torch.as_tensor(di_mutation, **f32), (n,)),
            torch.as_tensor(xlb, device=dev), torch.as_tensor(xub, device=dev),
            torch.as_tensor(mutation_rate, **f32),
        )
        X = X.cpu().numpy()[:n_children]
        return np.clip(X, xlb, xub)

    # ------------------------------------------------------------- access

    @property
    def values(self) -> np.ndarray:
        return self.param_arr

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {
            str(k): self.param_arr[:, i] for i, k in enumerate(self.param_keys)
        }


def children_draws(generator, npairs: int, P: int, n: int, crossover_rate: float,
                   device) -> Dict[str, torch.Tensor]:
    """The random draws of one children call: per pair the first parent
    ``i1`` on [0, P) and the second ``i2`` a shift on [1, P) away (so the
    two differ when P >= 2), the crossover bit ``is_x`` at
    ``crossover_rate``, and per gene the SBX uniforms and the two
    mutations' uniforms, (npairs, n) each."""
    i1 = torch.randint(0, P, (npairs,), generator=generator, device=device)
    if P >= 2:
        shift = torch.randint(1, P, (npairs,), generator=generator, device=device)
    else:
        shift = torch.ones_like(i1)
    u = torch.rand((1 + 3 * n) * npairs, generator=generator, device=device)
    return {
        "i1": i1,
        "i2": (i1 + shift) % P,
        "is_x": u[:npairs] < crossover_rate,
        "u_sbx": u[npairs:].view(3, npairs, n)[0],
        "u_m1": u[npairs:].view(3, npairs, n)[1],
        "u_m2": u[npairs:].view(3, npairs, n)[2],
    }


def children_core(values, draws, di_crossover, di_mutation, xlb, xub, mutation_rate):
    """Children of the parent rows ``values`` (P, n) from ``draws``
    (`children_draws`): a crossover pair emits the SBX children, another
    pair both parents mutated. One `ops.variation.sbx` call and two
    `mutation` calls, on the device of ``values``. Returns the
    (2 * npairs, n) children, pair i's in rows i and i + npairs."""
    p1, p2 = values[draws["i1"]], values[draws["i2"]]
    c1, c2 = sbx(draws["u_sbx"], p1, p2, di_crossover, xlb, xub)
    m1 = mutation(draws["u_m1"], p1, di_mutation, xlb, xub, mutation_rate)
    m2 = mutation(draws["u_m2"], p2, di_mutation, xlb, xub, mutation_rate)
    sel = draws["is_x"][:, None]
    return torch.cat([torch.where(sel, c1, m1), torch.where(sel, c2, m2)], dim=0)
