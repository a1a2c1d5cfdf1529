"""CPU tests of the benchmark (`python -m pytest portbench/tests -q` from the
repository root); the `cuda`-marked ones need a card and skip without one."""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """Skips a card-only test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
