"""One host thread for each test here, as ``run.py`` sets on the card: a
world's ranks take the calling process's thread count (``world.Job``), and
four ranks of as many threads as there are cores crowd out one another's
timing, so a tiny twin's warm-up rate, and with it the window's caps,
would swing with the load."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_host_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
