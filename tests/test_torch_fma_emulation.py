"""The f32-FMA flash kernels' CUDA source (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) run on the CPU by ``tools/fma_emulate.py``: one
thread a CUDA thread, each case against a double-precision reference.  No
card and no ``nvcc``; g++ builds the harness once for the module."""

import shutil

import pytest

from tools import fma_emulate


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if not shutil.which("g++"):
        pytest.skip("g++ is not installed")
    return fma_emulate.build(tmp_path_factory.mktemp("fma_emulate"))


@pytest.mark.parametrize("case", fma_emulate.CASES,
                         ids=["-".join(map(str, c)) for c in
                              fma_emulate.CASES])
def test_kernel_source_matches_the_reference(harness, case):
    done = fma_emulate.run_case(harness, case)
    assert done.returncode == 0, done.stdout + done.stderr
