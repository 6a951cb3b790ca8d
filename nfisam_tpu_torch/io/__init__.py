from .caesar import export_caesar_script, write_caesar_script
from .fg_io import (factor_graph_to_string, read_factor_graph_from_file,
                    write_factor_graph_to_file)
from .g2o import G2oToroPoseGraphReader
from .runbatch import (graph_file_parser, group_nodes_factors_incrementally,
                       inc_var_factor_to_dead_reckoning)
from .stream_policy import defer_ambiguous
