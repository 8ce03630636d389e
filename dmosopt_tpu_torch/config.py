"""Registry of shorthand names -> import paths, and string-path imports.

Port of ``dmosopt_tpu/config.py`` (reference dmosopt/config.py:5-48),
with the same shorthand names. Any other name is resolved as an import
path and, failing that, raises `NotImplementedError`.
"""

import importlib
import sys


def import_object_by_path(path: str):
    module_path, _, obj_name = path.rpartition(".")
    if module_path in ("__main__", ""):
        module = sys.modules["__main__"]
    else:
        module = importlib.import_module(module_path)
    return getattr(module, obj_name)


default_sampling_methods = {
    "slh": "dmosopt_tpu_torch.sampling.slh",
    "lh": "dmosopt_tpu_torch.sampling.lh",
    "mc": "dmosopt_tpu_torch.sampling.mc",
    "glp": "dmosopt_tpu_torch.sampling.glp",
    "sobol": "dmosopt_tpu_torch.sampling.sobol",
}

default_optimizers = {
    "nsga2": "dmosopt_tpu_torch.optimizers.nsga2.NSGA2",
    "age": "dmosopt_tpu_torch.optimizers.agemoea.AGEMOEA",
    "smpso": "dmosopt_tpu_torch.optimizers.smpso.SMPSO",
    "cmaes": "dmosopt_tpu_torch.optimizers.cmaes.CMAES",
    "trs": "dmosopt_tpu_torch.optimizers.trs.TRS",
}

default_surrogate_methods = {
    "gpr": "dmosopt_tpu_torch.models.gp.GPR_Matern",
    "egp": "dmosopt_tpu_torch.models.gp.EGP_Matern",
    "megp": "dmosopt_tpu_torch.models.gp.MEGP_Matern",
    "mdgp": "dmosopt_tpu_torch.models.deep_gp.MDGP_Matern",
    "mdspp": "dmosopt_tpu_torch.models.deep_gp.MDSPP_Matern",
    "vgp": "dmosopt_tpu_torch.models.svgp.VGP_Matern",
    "svgp": "dmosopt_tpu_torch.models.svgp.SVGP_Matern",
    "spv": "dmosopt_tpu_torch.models.svgp.SPV_Matern",
    "siv": "dmosopt_tpu_torch.models.svgp.SIV_Matern",
    "crv": "dmosopt_tpu_torch.models.svgp.CRV_Matern",
}

default_sa_methods = {
    "dgsm": "dmosopt_tpu_torch.sa.SA_DGSM",
    "fast": "dmosopt_tpu_torch.sa.SA_FAST",
}

default_feasibility_methods = {
    "logreg": "dmosopt_tpu_torch.feasibility.LogisticFeasibilityModel"
}


def as_tuple(value):
    """Normalize a scalar-or-sequence config value (optimizer cycling takes
    one name/kwargs dict or a sequence of them) to a tuple."""
    from collections.abc import Sequence

    if isinstance(value, Sequence) and not isinstance(value, (str, dict)):
        return tuple(value)
    return (value,)


def resolve(name_or_path, registry):
    """Resolve a shorthand or import path to an object; pass through callables."""
    if callable(name_or_path):
        return name_or_path
    path = registry.get(name_or_path, name_or_path)
    try:
        return import_object_by_path(path)
    except (ImportError, AttributeError) as e:
        raise NotImplementedError(
            f"component {name_or_path!r} (-> {path!r}) is not available "
            f"in dmosopt_tpu_torch: {e}"
        ) from e
