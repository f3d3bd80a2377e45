"""Hand-written Hopper kernels for the paper's ops, their plain PyTorch
versions, the block planner and the chain lowering.

Importing this package builds nothing: each kernel is compiled with nvcc
at its first launch (``kernels/_build.py``)."""
