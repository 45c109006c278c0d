"""Shared fixtures of the benchmark's own tests (run with
`python -m pytest benchmark/tests`); the `cuda` marker is the repository's
(pytest.ini), and a marked test decides inside itself whether a card is
there."""
from __future__ import annotations

import pytest
import torch

from benchmark.tests import toy


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toybench")
    toy.make_tree(root)
    return root


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
