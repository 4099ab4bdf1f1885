import os

# Tests run on the CPU, on a virtual 8-device mesh, unless JAX_PLATFORMS
# names another platform.  Platform and device count must be fixed
# before JAX creates its first backend, so they are set here, ahead of
# every test module's imports.  Tests marked `gpu` need the card and
# skip without one; `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`
# runs them there (chip_smoke.py does so in its parity phase).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the CUDA kernel); skipped "
                   "when JAX finds none")
