"""PyTorch and CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Entry points run on the card unless the caller asks for the CPU;
inside the ops the backend follows the tensor's device (CUDA tensors launch
the hand-written kernels in ``csrc/``, CPU tensors take the plain PyTorch
versions).  See ``repro_torch.core`` for the network engine and
``python -m repro_torch.mobilenet_inference`` for the paper's workload.
"""
