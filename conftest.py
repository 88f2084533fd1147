"""Root conftest: pytest markers shared by every test directory."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: tests that need a GPU; they skip without one "
                   "(run on the card with: python -m pytest -m gpu tests/)")
