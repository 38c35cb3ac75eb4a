"""Test configuration: force an 8-device virtual CPU mesh.

Tests run on the CPU backend: multi-device sharding is exercised on the
standard JAX stand-in (XLA_FLAGS=--xla_force_host_platform_device_count=8 on
the CPU backend — SURVEY.md §4) and the Pallas kernels run in interpret
mode. Must run before the first jax import.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# CPU-backend compile cache SEPARATE from the shared .jax_cache: that dir
# holds XLA:CPU AOT artifacts compiled on hosts with different CPU feature
# sets (amx/prefer-no-scatter), and loading them here warns "could lead to
# SIGILL" — and intermittently DID segfault the suite (observed round 5 in
# test_adaptive_caps_learned_and_parity). The env var also reaches
# subprocess tests (multihost workers, CLI).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache_cpu")
)
# Tests must not read/write the cross-process schedule store (order
# independence); the persistence test overrides this with a tmp path.
os.environ.setdefault("CNR_SCHEDULE_MEMO", "")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported (by a plugin or sitecustomize) before this
# conftest runs, in which case the env vars above are too late — override via
# jax.config as well (backends initialize lazily, so this still wins as long
# as no computation ran yet).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update(
    "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
)

# Make the repo root importable regardless of pytest invocation directory.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The reference repository's assets (not shipped here); tests that need them
# skip when they are absent. In-repo geometries live in examples/assets.
REFERENCE_DIR = "/root/reference"
ASSETS = os.path.join(_REPO_ROOT, "examples", "assets")
GEOMETRIES = os.path.join(REFERENCE_DIR, "neuralGeometries")
MATCAPS = os.path.join(REFERENCE_DIR, "matcaps")


def _asset(path: str) -> str:
    if not os.path.exists(path):
        pytest.skip(f"reference asset not available: {path}")
    return path


@pytest.fixture(scope="session")
def plane1_path() -> str:
    return _asset(os.path.join(GEOMETRIES, "plane_1.h5"))


@pytest.fixture(scope="session")
def car1_path() -> str:
    return _asset(os.path.join(GEOMETRIES, "car_1.h5"))


@pytest.fixture(scope="session")
def matcap_path() -> str:
    return _asset(os.path.join(MATCAPS, "Chrome.png"))


@pytest.fixture(scope="session")
def plane1_params(plane1_path):
    from cudaneuralrender.models import checkpoint

    return checkpoint.load_keras_h5(plane1_path)


@pytest.fixture(scope="session")
def csg_params():
    """The in-repo 3-input geometry: the reference architecture (9 layers,
    3->32->...->32->1) with trained weights."""
    from cudaneuralrender.models import checkpoint

    return checkpoint.load(os.path.join(ASSETS, "csg_demo.npz"))


@pytest.fixture(scope="session")
def anim_params():
    """The in-repo 4-input (x, y, z, frame) geometry."""
    from cudaneuralrender.models import checkpoint

    return checkpoint.load(os.path.join(ASSETS, "anim_demo.npz"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Clear JAX's in-process executable caches after every test module.

    The full suite compiles several hundred XLA:CPU programs across 8
    virtual devices; with all of them held live, the run deterministically
    SEGFAULTS inside an execution around the ~200-executable mark (round
    5; crash reproduces at the same test with or without the disk cache,
    while any half of the suite passes — a cumulative-resource failure in
    the CPU backend, not a code bug). Dropping compiled programs between
    modules bounds the live set; the per-host disk cache makes the few
    cross-module recompiles cheap AOT loads.
    """
    yield
    import jax

    jax.clear_caches()
