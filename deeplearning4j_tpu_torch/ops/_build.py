"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` into a shared library with a plain C
interface, at first use, into the build directory: ``_build/`` beside
``csrc/`` by default, or the directory ``DL4J_TPU_COMPILE_CACHE`` names
(``set_build_dir``; ``utils/compile_cache.enable_persistent_cache`` sets
it). A library is named by its key, ``<stem>-<digest>``: the digest hashes
the source, the nvcc flags and nvcc's version, so an edited source or
another compiler is rebuilt and never reused, and a clean checkout builds
on its first call. nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library as ``.log``.

Every nvcc run is counted: ``builds`` and ``build_seconds`` by source name
(and, with telemetry on, ``kernel_builds_total{source}`` and
``kernel_build_seconds{source}``). A library found in the build directory
is not a build. ``library_key``, ``library_bytes``, ``library_state`` and
``install_library`` are what a warm manifest ships and installs
(``utils/compile_cache.py``): a shipped library carries the release of the
nvcc that built it, and installs where its key is what this checkout's
source and flags give with that release, and this host has that nvcc or
none at all (a host that only loads libraries built elsewhere).

While a warm-up records (``recording()``), every library loaded for a
launch and every launch plan resolved is noted on the recording
(``Library.get``, ``note_plan``): what a warm manifest's entry holds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
#: the default build directory (no ``set_build_dir``, no environment variable)
BUILD_DIR = PKG / "_build"
#: environment variable naming the build directory: the persistent kernel cache
ENV_CACHE_DIR = "DL4J_TPU_COMPILE_CACHE"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc runs by source file name, and their wall seconds
builds = {}
build_seconds = {}
_count_lock = threading.Lock()
_dir = {"explicit": None}
_local = threading.local()


def set_build_dir(path):
    """Build into (and load from) ``path``; None returns to the environment
    variable, else ``_build/``. Returns the directory now in force."""
    _dir["explicit"] = None if path is None else pathlib.Path(path).resolve()
    return build_dir()


def build_dir() -> pathlib.Path:
    """The build directory in force: ``set_build_dir``'s, else
    ``$DL4J_TPU_COMPILE_CACHE``, else ``_build/`` beside ``csrc/``."""
    if _dir["explicit"] is not None:
        return _dir["explicit"]
    env = os.environ.get(ENV_CACHE_DIR)
    return pathlib.Path(env).resolve() if env else BUILD_DIR


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor in /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def _nvcc_release(path):
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[-1] if out.strip() else "unknown"


def nvcc_version():
    """nvcc's ``--version`` release line, or ``"none"`` where there is no
    nvcc (a host that can only load libraries built elsewhere)."""
    try:
        return _nvcc_release(nvcc())
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"


def library_key(source: pathlib.Path, release=None) -> str:
    """``<stem>-<digest>`` of the library ``source`` builds to: the digest
    hashes the source's bytes, the nvcc flags and nvcc's release line
    (``release``, by default this host's ``nvcc_version()``)."""
    h = hashlib.sha256(source.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update((release or nvcc_version()).encode())
    return f"{source.stem}-{h.hexdigest()[:16]}"


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the shared library for the current ``source`` lives once built."""
    return build_dir() / f"{library_key(source)}.so"


def _count(name, seconds):
    with _count_lock:
        builds[name] = builds.get(name, 0) + 1
        build_seconds[name] = build_seconds.get(name, 0.0) + seconds
    from deeplearning4j_tpu_torch import telemetry as _tm
    reg = _tm.get_registry()
    reg.counter("kernel_builds_total",
                "nvcc runs by kernel source (a library found in the build "
                "directory, or installed from a warm manifest, is none)").inc(source=name)
    reg.counter("kernel_build_seconds",
                "wall seconds of nvcc runs by kernel source").inc(seconds, source=name)


def reset_counts():
    with _count_lock:
        builds.clear()
        build_seconds.clear()


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` unless the library for its key exists. Returns the
    library path; raises with nvcc's output when the build fails."""
    so = library_path(source)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    _count(source.name, time.perf_counter() - t0)
    return so


def source_named(name) -> pathlib.Path:
    """The kernel source ``csrc/<name>``; a name that is not a file there
    (a path, a foreign name) raises ValueError."""
    path = CSRC / str(name)
    if pathlib.Path(str(name)).name != str(name) or not path.is_file():
        raise ValueError(f"no kernel source {name!r} in {CSRC}")
    return path


def cache_enabled() -> bool:
    """Whether the caller chose the build directory (``set_build_dir`` or
    ``$DL4J_TPU_COMPILE_CACHE``) rather than the default ``_build/``."""
    return _dir["explicit"] is not None or bool(os.environ.get(ENV_CACHE_DIR))


def library_bytes(source: pathlib.Path):
    """(key, bytes, nvcc release) of the built library of ``source`` in the
    build directory, or None when it is not built there."""
    so = library_path(source)
    return (so.stem, so.read_bytes(), nvcc_version()) if so.exists() else None


def library_state(source_name, key, release=None) -> str:
    """How a library shipped under ``key``, built by nvcc ``release``
    (default: this host's), stands here: ``"mismatch"`` when ``key`` is not
    what ``csrc/<source_name>`` and the flags give with that release, or
    this host has another nvcc (it builds its own); else ``"present"`` when
    the library of the current source is in the build directory, or
    ``"absent"``."""
    try:
        source = source_named(source_name)
    except ValueError:
        return "mismatch"
    local = nvcc_version()
    release = release or local
    if library_key(source, release) != key or local not in ("none", release):
        return "mismatch"
    return "present" if library_path(source).exists() else "absent"


def install_library(source_name, key, data, release=None) -> bool:
    """Write a library shipped in a warm manifest where this host loads the
    current source's library from, unless ``library_state`` says
    ``"mismatch"`` (False, nothing written). A library already there is
    kept."""
    state = library_state(source_name, key, release)
    if state == "mismatch":
        return False
    if state == "absent":
        so = library_path(source_named(source_name))
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        tmp.write_bytes(data)
        os.replace(tmp, so)
    return True


class Library:
    """A kernel library loaded once, on first use, by ``ctypes``.
    ``declare(lib)`` sets each entry point's ``argtypes`` and ``restype``."""

    def __init__(self, source: pathlib.Path, declare):
        self.source = source
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> pathlib.Path:
        return build(self.source)

    def get(self):
        rec = getattr(_local, "rec", None)
        if rec is not None:
            rec.libraries.add(self.source.name)
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


class Recording:
    """What one warm-up launched: kernel sources by name, and the launch
    plans resolved, ``{(kernel, key): (config, plan fields)}``."""

    def __init__(self):
        self.libraries = set()
        self.plans = {}


@contextlib.contextmanager
def recording():
    """Record this thread's library loads and plan resolutions (a warm-up
    in ``utils/compile_cache.aot_compile``); nests, the inner one also
    noting into the outer."""
    outer = getattr(_local, "rec", None)
    rec = Recording()
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = outer
        if outer is not None:
            outer.libraries |= rec.libraries
            outer.plans.update(rec.plans)


@contextlib.contextmanager
def launch_tally():
    """Count this thread's kernel launches by counter name (``note_launch``)
    while the block runs: a CUDA-graph capture's own launches, apart from
    those other threads of the process make meanwhile. Nests, the inner
    tally also counting into the outer."""
    outer = getattr(_local, "tally", None)
    tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = outer
        if outer is not None:
            for name, n in tally.items():
                outer[name] = outer.get(name, 0) + n


def note_launch(*names):
    """Count one launch under each of ``names`` on this thread's tally, if
    one is open (the wrappers call it beside their own counts)."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        for name in names:
            tally[name] = tally.get(name, 0) + 1


def note_plan(kernel, key, config, plan):
    """Note one resolved launch plan (a NamedTuple) on this thread's
    recording, if any."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.plans[(kernel, key)] = (config, plan._asdict())


def device_index(dev) -> int:
    import torch
    return dev.index if dev.index is not None else torch.cuda.current_device()
