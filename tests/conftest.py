"""Test configuration: CPU with float64 for golden-value parity.

Multi-device sharding tests (tests/test_dist.py) spawn subprocesses with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu, since
the flag must be set before jax import and slows every compile when active.
Tests marked `gpu` need an NVIDIA card and run chip_smoke.py there in a
subprocess; the `gpu` fixture skips them elsewhere.
"""
import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib

import pytest

DATA = pathlib.Path("/root/reference/data")


@pytest.fixture(scope="session")
def data_dir():
    return DATA


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a card.  Decided here, when the test
    runs, so every test worker collects the same tests."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
