"""One intra-op thread for a port test module (not a test file): a module
that imports ``one_intra_op_thread`` runs its tests with
``torch.set_num_threads(1)`` and restores the count after its last test.

Beside the suite's other workers, a thread team per core on every eager op
makes each op wait for cores: on an 8-core host (torch 2.13.0+cpu) the
port's files took 4346 s of test time in a six-worker run of the whole
suite, and 1318 s in a six-worker run of those files alone with one thread,
with the same results (``test_torch_train.py`` found it first)."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
