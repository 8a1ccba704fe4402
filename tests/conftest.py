"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the CPU; multi-device tests use the standard JAX virtual-device
mesh (--xla_force_host_platform_device_count), per SURVEY.md §4.  Tests that
need the GPU carry the `gpu` marker and decide inside a fixture whether a
card is present; `python chip_smoke.py` runs the same checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"


def pytest_addoption(parser):
    parser.addoption("--regen-golden", action="store_true",
                     help="regenerate golden snapshot PNGs")
