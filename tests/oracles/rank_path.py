"""A fixture that hands spawned ranks a `sys.path` on which `profile` is
the standard library's.

`parallel.mesh.run_ranks` spawns each rank with this process's
`sys.path`. `tests/test_stf_io.py` puts `tools/` (which holds a
`profile.py`) first on it, and a rank then fails importing `cProfile`
(through which torch's optimizers import `profile`) whenever its test
shares a pytest worker with that file and runs after it. The fixture
drops every folder that holds a `profile.py`, the standard library's own
folder apart, for the test's duration.
"""

import os
import sys

import pytest


@pytest.fixture(autouse=True)
def stdlib_profile_path(monkeypatch):
    stdlib = os.path.dirname(os.__file__)
    monkeypatch.setattr(sys, 'path', [
        p for p in sys.path if p == stdlib
        or not os.path.isfile(os.path.join(p or '.', 'profile.py'))])
