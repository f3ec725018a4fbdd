"""The benchmark's own tests: ``python -m pytest kserbench/tests`` from the
root of the repository.  Tests marked ``cuda`` need a card and skip
without one."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY_SPEC = os.path.join(DATA, "tiny_benchmark.json")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def run_tiny(workload: str, seed: int = 5, seconds: float = 1.5,
             trace: bool = False, control: bool = False, device="cpu",
             spec_path: str = TINY_SPEC, base: str = DATA) -> dict:
    """One run of a tiny cell through the whole harness, the port on its
    plain kernels (``device`` "cpu")."""
    from kserbench.harness.cell import run_cell
    from kserbench.harness.spec import Spec
    return run_cell(workload, seed, seconds, trace, device,
                    Spec(spec_path, base), control)
