"""Test settings of the benchmark's own tests (run them with
``python -m pytest perfbench/tests``; the card's with ``-m cuda`` on the card).

Imports nothing of JAX: the benchmark runs where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
