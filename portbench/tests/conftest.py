# The marker of tests that need an NVIDIA GPU with CUDA; such tests skip
# with a reason, decided inside a fixture, where no GPU is present.


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with CUDA and nvcc (the port's kernels)",
    )
