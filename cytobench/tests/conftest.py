import tempfile
from pathlib import Path

import pytest

from . import tiny


@pytest.fixture(scope="session")
def tiny_root():
    """A benchmark copy with the tiny fp32 cell added, made once."""
    return tiny.make(Path(tempfile.mkdtemp(prefix="cytobench_tiny_")))


@pytest.fixture(scope="session")
def tiny_root_vith():
    """The tiny fp32 cell under the limits of ``vith-2048-b8``."""
    return tiny.make(Path(tempfile.mkdtemp(prefix="cytobench_tiny_vith_")), like="vith-2048-b8")
