"""GPU lane: the device routes on the card, against the host routes.

Run on a machine with a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Every test skips without a GPU backend; the `gpu` fixture decides, so
collection is the same everywhere. With NGSBITS_DEVICE_ENGINES unset the
device routes engage on their own, which is what these tests pin.
"""

import numpy as np
import pytest

import device_parity as dp

pytestmark = pytest.mark.gpu

AUTO: dict = {}


@pytest.fixture(scope="module")
def gpu():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/)")
    return jax


@pytest.fixture(scope="module")
def inputs(gpu, tmp_path_factory):
    return dp.make_inputs(tmp_path_factory.mktemp("gpu_lane"))


@pytest.fixture(autouse=True)
def _auto_dispatch(monkeypatch):
    monkeypatch.delenv("NGSBITS_DEVICE_ENGINES", raising=False)


def test_device_routes_engage_by_default(gpu):
    from ngsbits_tpu.ops.device_reduce import use_device
    from ngsbits_tpu.utils.backend import has_accelerator
    assert has_accelerator() and use_device()


def test_readqc_on_card(inputs, tmp_path, monkeypatch):
    dp.check_readqc(inputs, tmp_path, monkeypatch, AUTO)


def test_seqpurge_on_card(inputs, tmp_path, monkeypatch):
    dp.check_seqpurge(inputs, tmp_path, monkeypatch, AUTO)


@pytest.mark.parametrize("tool,extra", [
    ("BedCoverage", []),
    ("BedLowCoverage", ["-cutoff", "5"]),
    ("BedHighCoverage", ["-cutoff", "5"]),
])
def test_coverage_tools_on_card(inputs, tmp_path, monkeypatch, tool, extra):
    dp.check_coverage_tool(inputs, tmp_path, monkeypatch, AUTO, tool, extra)


def test_mappingqc_on_card(inputs, tmp_path, monkeypatch):
    dp.check_mappingqc(inputs, tmp_path, monkeypatch, AUTO)


def test_pileup_on_card(inputs, monkeypatch):
    dp.check_pileup(inputs, monkeypatch, AUTO)


def test_read_stream_spill_on_card(gpu, monkeypatch):
    dp.check_read_stream_spill(monkeypatch)


@pytest.mark.parametrize("L,kind", [(151, "overlap"), (152, "n_rich")])
def test_insert_scan_on_card(gpu, L, kind):
    dp.check_insert_scan(L, kind)


def test_pearson_on_card(gpu):
    from ngsbits_tpu.core.basicstats import correlation
    from ngsbits_tpu.ops.device_reduce import pearson_from_genotypes
    rng = np.random.default_rng(5)
    g1 = rng.choice([0.0, 0.5, 1.0], size=70000)
    g2 = np.where(rng.random(70000) < 0.8, g1,
                  rng.choice([0.0, 0.5, 1.0], size=70000))
    assert abs(pearson_from_genotypes(g1, g2) - correlation(list(g1), list(g2))) < 1e-9
