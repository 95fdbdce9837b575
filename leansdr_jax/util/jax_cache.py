"""Persistent-compilation-cache setup.

JAX_COMPILATION_CACHE_DIR, when set, is used as it is (JAX reads it
itself) and no other directory is set. Otherwise the cache sits at the
fixed `.jax_cache/` of the checkout — a fixed path, because the path is
part of the cache key.

When JAX is held to the CPU (JAX_PLATFORMS=cpu, as the tests run) the
directory is keyed further by the host CPU: XLA:CPU AOT results embed
the compile machine's feature set, and a cache written on a different
host is loaded anyway with only a warning ("could lead to execution
errors such as SIGILL") — observed to produce wrong numerics when runs
move between machines. The platform is read from the configuration, not
from the backend: initialising the backend here would break a later
jax.distributed.initialize().
"""

import hashlib
import os
from pathlib import Path


def machine_tag() -> str:
    # The ISA flag line alone is NOT discriminating enough: two CPUs
    # with identical flags but different models get different LLVM
    # tuning features, which XLA:CPU AOT results embed. Key by
    # vendor/family/model/stepping/model-name + flags.
    keys = ("vendor_id", "cpu family", "model", "model name",
            "stepping", "flags")
    try:
        with open("/proc/cpuinfo") as f:
            lines = []
            for line in f:
                k = line.split(":")[0].strip()
                if k in keys:
                    lines.append(line.strip())
                if k == "flags":
                    break          # first core is enough
            cpu = "\n".join(lines)
    except OSError:
        import platform
        cpu = platform.processor()
    return hashlib.sha1(cpu.encode()).hexdigest()[:8]


def cache_dir(repo_root: Path | str | None = None) -> str:
    """The directory setup_cache uses for the current backend."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    root = Path(repo_root) if repo_root else \
        Path(__file__).resolve().parent.parent.parent
    path = root / ".jax_cache"
    platforms = jax.config.jax_platforms or os.environ.get(
        "JAX_PLATFORMS", "")
    if platforms.split(",")[0] == "cpu":
        path = path / machine_tag()
    return str(path)


def setup_cache(repo_root: Path | str | None = None) -> None:
    """Enable the persistent compilation cache (see module docstring).
    LEANSDR_NO_JAX_CACHE=1 skips it entirely."""
    if os.environ.get("LEANSDR_NO_JAX_CACHE"):
        return
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir(repo_root))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
