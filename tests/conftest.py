"""Test config: CPU JAX with 8 virtual devices, so the multi-device
sharding logic runs on any machine (SURVEY.md §4) and the GPU trace
kernel runs in Triton interpret mode where a test asks for it.

`pytest --gpu` leaves the platform to JAX instead (a CUDA GPU where one
is present), so the tests marked `gpu` run the compiled kernel; without
a card they skip.  The platform is set through jax.config before any
backend initializes."""

import jax
import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="run on JAX's default platform (a CUDA GPU) "
                          "instead of 8 virtual CPU devices")


def pytest_configure(config):
    if not config.getoption("--gpu"):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (platform is {dev.platform!r}; "
                    "run pytest --gpu on a GPU machine)")
    return dev
