"""The benchmark's own tests. Tests that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is none;
the decision is made when the fixture runs, never at import.

    python -m pytest isacbench/tests -q            # CPU: rehearsal, files, counts
    python -m pytest isacbench/tests -q -m card    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
