"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set the environment before JAX initializes. LEANSDR_TEST_GPU=1
leaves JAX on its default platform instead, for the tests marked `gpu`
(run on the card: LEANSDR_TEST_GPU=1 python -m pytest -m gpu tests/).
"""

import os
from pathlib import Path

ON_GPU = os.environ.get("LEANSDR_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# Key the persistent cache by the host CPU: XLA:CPU AOT results embed
# target machine features, and a cache written on a different host is
# loaded anyway with a "could lead to SIGILL" warning (observed to
# produce wrong numerics when rounds run on heterogeneous machines).
import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from leansdr_jax.util.jax_cache import setup_cache

setup_cache()
# LEANSDR_TEST_CACHE_RO=1: read the persistent cache but never WRITE it
# (threshold no compile reaches). Used to bisect the one-process
# tail-of-suite crash: it still crashed (SIGSEGV instead of SIGABRT) at
# the same backend_compile_and_load site, exonerating the cache-write
# path — the crash is resource accumulation inside XLA:CPU compilation
# itself after ~190 tests' worth of live compiled programs.
if os.environ.get("LEANSDR_TEST_CACHE_RO"):
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      1 << 20)

import subprocess

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REF_SRC = Path("/root/reference")
REF_BUILD = REPO / ".ref_build"
GOLDEN = REPO / ".golden"


def _build_reference() -> Path | None:
    """Build the reference C++ apps (cached in .ref_build)."""
    apps = REF_BUILD / "src" / "apps"
    if all((apps / b).exists() for b in
           ("leandvb", "leandvbtx", "leantsgen", "leanchansim")):
        return apps
    if not REF_SRC.exists():
        return None
    REF_BUILD.mkdir(exist_ok=True)
    subprocess.run(["cp", "-r", str(REF_SRC / "src"), str(REF_BUILD)],
                   check=True)
    r = subprocess.run(["make", "VERSION=ref", "leandvb", "leandvbtx",
                        "leantsgen", "leanchansim"],
                       cwd=apps, capture_output=True)
    if r.returncode != 0:
        return None
    return apps


def file_stdin(raw: bytes):
    """A real-file stdin for running the reference binary: it is only
    deterministic on FILE input — on a pipe its scheduler sees
    load-dependent read() chunk sizes, which perturb the feedback loops
    (README.coding.md:31-35)."""
    import tempfile
    f = tempfile.TemporaryFile()
    f.write(raw)
    f.seek(0)
    return f


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs compiled kernels on an NVIDIA GPU; skips "
        "elsewhere")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: LEANSDR_TEST_GPU=1 python -m "
                    "pytest -m gpu tests/ on the card")


@pytest.fixture(scope="session")
def ref_apps():
    apps = _build_reference()
    if apps is None:
        pytest.skip("reference binaries unavailable")
    return apps


@pytest.fixture(scope="session")
def ref_mlmrx(ref_apps):
    """The reference leanmlmrx binary, built against tests/fftw_shim
    (the container has no libfftw3f; the shim implements the 6 fftwf_*
    symbols leanmlmrx.cc uses with a radix-2 FFT)."""
    binary = ref_apps / "leanmlmrx"
    if binary.exists():
        return binary
    shim = REPO / "tests" / "fftw_shim"
    r = subprocess.run(
        ["g++", "-O2", "-I", str(shim), "-I", str(REF_BUILD / "src"),
         str(ref_apps / "leanmlmrx.cc"), str(shim / "fftw_shim.c"),
         "-lpthread", "-lm", "-o", str(binary)],
        capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"leanmlmrx build failed: {r.stderr[-300:]}")
    return binary


@pytest.fixture(scope="session")
def golden_dir(ref_apps):
    """Generate golden stimulus/output files once per session."""
    GOLDEN.mkdir(exist_ok=True)
    ts = GOLDEN / "ts300.bin"
    if not ts.exists():
        with open(ts, "wb") as f:
            subprocess.run([str(ref_apps / "leantsgen"), "-c", "300"],
                           stdout=f, check=True)
    return GOLDEN


# -- XLA:CPU live-program cap -------------------------------------------
# The full suite compiles many hundreds of distinct programs in one
# interpreter; past ~190 tests XLA:CPU reproducibly crashes INSIDE
# backend_compile_and_load (SIGABRT or SIGSEGV at the same site, with or
# without the persistent-cache write path — see the bisect notes above).
# Dropping jax's in-process executable caches every N tests keeps the
# number of live compiled programs bounded; re-runs of shared programs
# reload from the machine-keyed persistent cache instead of recompiling.
_CLEAR_EVERY = int(os.environ.get("LEANSDR_TEST_CLEAR_EVERY", "40"))
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_live_xla_programs():
    yield
    _test_counter["n"] += 1
    if _CLEAR_EVERY and _test_counter["n"] % _CLEAR_EVERY == 0:
        import jax as _jax
        _jax.clear_caches()
