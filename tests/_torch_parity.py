"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``):
seeded numpy inputs handed to both the JAX reference and the port."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.mobilenet_inference import ARCHS

#: fp32 tolerance of the reference's own network tests
#: (tests/test_network.py::test_pallas_interpret_matches_xla).
FP32_TOL = 2e-5
#: bf16 kernel-level tolerance, relative to the largest magnitude.
BF16_KERNEL_TOL = 1e-2
#: bf16 network-level tolerance (examples/mobilenet_inference.py:43).
BF16_REL_TOL = 5e-2

#: --arch name -> spec builder name, the same in both packages.
SPECS = {arch: build.__name__ for arch, build in ARCHS.items()}

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rand(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_jax(a, dtype: str = "float32"):
    return None if a is None else jnp.asarray(a, JNP[dtype])


def to_torch(a, dtype: str = "float32"):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(
        TORCH[dtype])


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def rel_err(got, want) -> float:
    g, w = as_f32(got), as_f32(want)
    return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))


def assert_match(got, want, dtype: str, bf16_tol: float = BF16_KERNEL_TOL):
    """fp32: rtol = atol = 2e-5.  bf16: max error relative to the largest
    magnitude within ``bf16_tol``."""
    assert tuple(got.shape) == tuple(want.shape), (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=FP32_TOL,
                                   atol=FP32_TOL)
    else:
        assert rel_err(got, want) <= bf16_tol, rel_err(got, want)
