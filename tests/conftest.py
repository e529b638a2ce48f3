"""Test harness setup: the CPU backend with 8 virtual devices (SURVEY.md
§4.3 item 4) unless JAX_PLATFORMS names another, set before JAX is
imported anywhere."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Persistent compile cache: the suite compiles many small shapes; reruns
# should not pay XLA compile time again.  One fixed path in the checkout
# (listed in .gitignore) unless the caller names one.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(_CHECKOUT, ".jax_cache")
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import gc
import subprocess
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
REFERENCE_SRC = Path("/root/reference")
REF_BUILD = Path("/root/build-ref/needleman-wunsch")


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mappings():
    """Drop compiled XLA executables between test modules.

    XLA:CPU JIT leaves ~3 anonymous mappings per compiled executable
    and the full suite compiles enough distinct programs to exhaust
    the kernel's vm.max_map_count (65530) — the process then SEGVs
    inside an unrelated later compile (observed twice at ~97% of the
    suite; /proc/<pid>/maps hits ~65k right before death).  Clearing
    caches at module boundaries bounds the growth; cross-module
    recompiles hit the persistent disk cache, so the cost is load
    time, not re-optimization."""
    yield
    jax.clear_caches()
    gc.collect()


# safety valve: if a single module's compiles approach the kernel map
# limit anyway, drop caches mid-module (threshold leaves headroom for
# one more large compile + the XLA compiler's own transient mappings)
_MAPS_LIMIT = 45_000


@pytest.fixture(autouse=True)
def _map_count_guard():
    yield
    try:
        import os as _os

        n = sum(1 for _ in open(f"/proc/{_os.getpid()}/maps"))
    except OSError:  # non-Linux: the module-scope clear still bounds us
        return
    if n > _MAPS_LIMIT:
        jax.clear_caches()
        gc.collect()


@pytest.fixture(scope="session")
def reference_binary():
    """Path to a built reference binary, or skip.

    Used only for differential tests; golden tests carry their own
    expected bytes and always run.
    """
    if REF_BUILD.exists():
        return str(REF_BUILD)
    if not REFERENCE_SRC.exists():
        pytest.skip("reference sources not available")
    build = Path("/tmp/nw-ref-build")
    binary = build / "needleman-wunsch"
    if not binary.exists():
        build.mkdir(parents=True, exist_ok=True)
        for f in REFERENCE_SRC.iterdir():
            if f.suffix in (".c", ".h") or f.name == "Makefile":
                (build / f.name).write_bytes(f.read_bytes())
        r = subprocess.run(
            ["make", "CFLAGS=-std=gnu99 -O2 -fcommon -DNDEBUG"],
            cwd=build,
            capture_output=True,
        )
        if r.returncode != 0 or not binary.exists():
            pytest.skip("could not build reference binary")
    return str(binary)


@pytest.fixture(scope="session")
def reference_debug_binary():
    """Reference built WITHOUT -DNDEBUG (`make debug`): enables the
    dbg.h debug() stderr traces incl. the branch-count print."""
    if not REFERENCE_SRC.exists():
        pytest.skip("reference sources not available")
    build = Path("/tmp/nw-ref-debug-build")
    binary = build / "needleman-wunsch"
    if not binary.exists():
        build.mkdir(parents=True, exist_ok=True)
        for f in REFERENCE_SRC.iterdir():
            if f.suffix in (".c", ".h") or f.name == "Makefile":
                (build / f.name).write_bytes(f.read_bytes())
        r = subprocess.run(
            ["make", "debug", "CFLAGS=-std=gnu99 -O0 -g -fcommon"],
            cwd=build,
            capture_output=True,
        )
        if r.returncode != 0 or not binary.exists():
            pytest.skip("could not build reference debug binary")
    return str(binary)


def run_ref(binary, args, stdin: bytes):
    r = subprocess.run(
        [binary, *args], input=stdin, capture_output=True, timeout=120
    )
    return r.returncode, r.stdout, r.stderr


def run_ours(args, stdin: bytes, prog="needleman-wunsch"):
    """Run our CLI in-process (keeps jit caches warm across cases)."""
    import io

    from nw_tpu import cli

    out, err = io.BytesIO(), io.BytesIO()
    rc = cli.main([prog, *args], stdin=io.BytesIO(stdin), stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()
