def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA card; skips without one")
