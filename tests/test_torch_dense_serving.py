"""The dense and VLM transformers' serving path at their smoke configs on
the CPU, held against the JAX package as ``tests/test_torch_dense.py``
holds their layers (its archs, weights and tolerances; the checks of
``_torch_parity.py``): ``hidden_states`` and ``prefill`` at 20 and 100
tokens, decode steps from the reference's cache, ``prefill_by_stepping``,
greedy generation and the static-buffer decode step.  A file of its own
so that the two halves run on two test workers."""
import pytest

import _torch_threads  # noqa: F401

from _torch_parity import (LM_DTYPES, PROMPTS, check_decode_step_into,
                           check_decode_steps, check_generate_fp32,
                           check_prefill, check_prefill_by_stepping_fp32,
                           check_prefill_equals_stepping)
from test_torch_dense import DENSE


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", DENSE)
def test_hidden_states_and_prefill_match_reference(arch, s, dtype):
    check_prefill(arch, dtype, s)


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch, dtype):
    check_decode_steps(arch, dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_by_stepping_matches_reference_fp32(arch):
    check_prefill_by_stepping_fp32(arch)


@pytest.mark.parametrize("dtype,s,max_len", [
    ("float32", 3, 16), ("float32", 40, 60), ("bfloat16", 9, 24)])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_equals_prefill_by_stepping(arch, dtype, s, max_len):
    check_prefill_equals_stepping(arch, dtype, s, max_len)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_reference_fp32(arch):
    check_generate_fp32(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_into_writes_in_place_and_matches_decode_step(arch):
    check_decode_step_into(arch)
