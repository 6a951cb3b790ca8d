"""The JAX repo's ``examples/toy_examples/`` in the port: the R^2 chain and
range graphs, the SE(2) loop closure and the five-node SE(2) range graph."""
