"""The device formulations on the CPU backend (NGSBITS_DEVICE_ENGINES=1)
against the host routes, on seeded inputs; tests/test_gpu_lane.py runs the
same checks on the card."""

import pytest

pytest.importorskip("jax")

import device_parity as dp

FORCE = {"NGSBITS_DEVICE_ENGINES": "1"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return dp.make_inputs(tmp_path_factory.mktemp("device_routes"))


def test_readqc_cli_device_route(inputs, tmp_path, monkeypatch):
    dp.check_readqc(inputs, tmp_path, monkeypatch, FORCE)


def test_seqpurge_cli_device_route(inputs, tmp_path, monkeypatch):
    dp.check_seqpurge(inputs, tmp_path, monkeypatch, FORCE)


@pytest.mark.parametrize("tool,extra", [
    ("BedCoverage", []),
    ("BedLowCoverage", ["-cutoff", "5"]),
    ("BedHighCoverage", ["-cutoff", "5"]),
])
def test_coverage_cli_device_route(inputs, tmp_path, monkeypatch, tool, extra):
    dp.check_coverage_tool(inputs, tmp_path, monkeypatch, FORCE, tool, extra)


def test_mappingqc_cli_device_route(inputs, tmp_path, monkeypatch):
    dp.check_mappingqc(inputs, tmp_path, monkeypatch, FORCE)


def test_pileup_device_route(inputs, monkeypatch):
    dp.check_pileup(inputs, monkeypatch, FORCE)


def test_device_read_stream_spill(monkeypatch):
    dp.check_read_stream_spill(monkeypatch)


@pytest.mark.parametrize("L,kind", [
    (151, "overlap"), (152, "overlap"), (151, "n_rich"), (152, "n_rich"),
])
def test_insert_scan_xla_matches_host(L, kind):
    dp.check_insert_scan(L, kind)
