"""Drop-in style entry module: `from dmosopt_tpu_torch import dmosopt`.

Port of ``dmosopt_tpu/dmosopt.py``. Mirrors the reference's primary
import surface (`from dmosopt import dmosopt; dmosopt.run(...)`,
reference dmosopt/dmosopt.py:2501) so migrating callers only change the
package name. Everything here re-exports the port's driver and strategy.
"""

from dmosopt_tpu_torch.driver import (  # noqa: F401
    DistOptimizer,
    dopt_dict,
    dopt_init,
    eval_obj_fun_mp,
    eval_obj_fun_sp,
    run,
)
from dmosopt_tpu_torch.strategy import DistOptStrategy  # noqa: F401
