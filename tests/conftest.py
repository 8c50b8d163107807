def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the repro_torch CUDA kernels); "
        "skips without one")
