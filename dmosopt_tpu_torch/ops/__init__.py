from dmosopt_tpu_torch.ops.filtering import filter_samples  # noqa: F401
from dmosopt_tpu_torch.ops.dominance import (  # noqa: F401
    dominance_degree_matrix,
    dominance_matrix,
    non_dominated_rank,
)
from dmosopt_tpu_torch.ops.distances import (  # noqa: F401
    crowding_distance,
    duplicate_mask,
    euclidean_distance_metric,
    pairwise_distances,
)
from dmosopt_tpu_torch.ops.sort import (  # noqa: F401
    lexsort,
    order_mo,
    remove_worst,
    sort_mo,
    top_k_mo,
)
from dmosopt_tpu_torch.ops.variation import (  # noqa: F401
    KERNEL_LAUNCHES,
    offspring,
    polynomial_mutation,
    sbx_crossover,
    tournament_probabilities,
    tournament_selection,
)
