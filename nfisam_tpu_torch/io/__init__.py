from .fg_io import read_factor_graph_from_file
from .runbatch import graph_file_parser, group_nodes_factors_incrementally
from .stream_policy import defer_ambiguous
