"""Test config: run on the CPU with an 8-device virtual mesh (multi-device
sharding tests run on virtual devices). GPU-only tests carry the `gpu`
marker and skip here; chip_smoke.py runs the GPU path end to end."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# tests compile fresh: keep the persistent compilation cache out of the run
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402,F401
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cbox_scene():
    from vision_tpu.scene.scene import Scene
    from tests.fixtures import CBOX_JSON
    return Scene(CBOX_JSON, scene_dir=os.path.dirname(__file__))
