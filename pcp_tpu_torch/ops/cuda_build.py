"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and compiles on its own
into ``<repo>/build/lib<name>-<hash>.so`` for ``sm_90a``. The hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
builds anew and an unchanged one is
loaded as it is. Nothing is built at import: the first call that needs a
kernel builds it, and :func:`build` builds several at once, one nvcc process
per source, all started together. nvcc runs with ``-Xptxas -v``; what it
printed (registers, shared memory and spills of each kernel) is kept beside
the library and read with :func:`build_log`.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries = {}


def nvcc_path():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name):
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None):
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet. Returns ``{name: path of the shared library}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    errors = []
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def build_log(name):
    """nvcc's output from the build of kernel library ``name``."""
    return build([name])[name].with_suffix(".log").read_text()


def load(name):
    """The ctypes handle of kernel library ``name``, built on first use."""
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build([name])[name]))
    return _libraries[name]
