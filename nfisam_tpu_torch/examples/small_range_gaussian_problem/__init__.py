"""The JAX repo's ``examples/small_range_gaussian_problem/`` in the port:
case1 (6 SE(2) poses, 2 landmarks, 8 range factors) by NF-iSAM
(``run_nfisam``), its nested-sampling reference a step at a time
(``generate_reference_solution``), and the MMD of a run's step against a
reference (``compute_mmd``).  By default the two runs write under
``small_range_gaussian_problem`` in ``tempfile.gettempdir()``: the run
directories ``run{N}`` and ``ns_reference``, as the JAX examples do beside
themselves."""
import os

from ...scripts.manhattan_scale_run import REPO

FAMILY = "small_range_gaussian_problem"
FG = os.path.join(REPO, "data", "case1_factor_graph.fg")


def case1_graph(parse=None, group=None) -> tuple:
    """(nodes, truth, factors, batches of one pose a step) of case1;
    ``parse`` and ``group`` default to the port's ``graph_file_parser``
    and ``group_nodes_factors_incrementally``."""
    if parse is None:
        from ...io import (graph_file_parser as parse,
                           group_nodes_factors_incrementally as group)
    nodes, truth, factors = parse(FG, "fg")
    return nodes, truth, factors, group(nodes, factors, incremental_step=1)
