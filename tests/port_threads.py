"""The port's test modules run torch on one thread (``one_thread``): the
suite runs six workers on the machine's cores, and a pool of torch threads
in each spends the tiny ops' time contending with the others (a module
of the port's tests ran 1.7x slower with six copies of it at once)."""

import pytest

from dist_support import one_thread


@pytest.fixture(autouse=True, scope="module")
def torch_on_one_thread():
    """Torch on one thread for the whole module, restored after it."""
    with one_thread():
        yield
