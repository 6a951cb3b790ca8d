"""The JAX repo's ``examples/manhattan_world_with_range/`` in the port: a
lawnmower Manhattan-world range-SLAM dataset generated and solved
incrementally (``generate_and_run``)."""
