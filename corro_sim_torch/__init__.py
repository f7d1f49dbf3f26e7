"""corro_sim_torch — the PyTorch/CUDA port of the corro-sim simulator.

A second package beside the JAX one: same module paths, same function
names, bit-identical results, with the CR-SQLite merge kernel written by
hand in CUDA C++ for Hopper. Entry points run on CUDA unless the caller
passes ``device="cpu"``. Importing the package imports nothing else.
"""
