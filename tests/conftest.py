import os

# The suite runs on the CPU backend unless the caller picks another
# platform (the GPU lane runs with JAX_PLATFORMS=cuda).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REF_DATA = pathlib.Path("/root/reference/src/tools-TEST")


@pytest.fixture
def ref_data_in():
    return REF_DATA / "data_in"


@pytest.fixture
def ref_data_out():
    return REF_DATA / "data_out"
