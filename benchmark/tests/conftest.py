"""The benchmark's own tests (``python -m pytest benchmark/tests``).

Tests that need an NVIDIA card carry the ``cuda`` marker and decide inside
the test whether a card is there."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is False")
