def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; the test skips itself where "
        "torch.cuda.is_available() is false")
