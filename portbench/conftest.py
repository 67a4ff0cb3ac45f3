"""pytest settings of the benchmark's own tests (portbench/tests/)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; such a test skips itself (in a fixture) when "
        "torch.cuda.is_available() is False")
