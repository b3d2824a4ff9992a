"""Build and load the port's CUDA kernels.

Each ``rat_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` into its own shared library under
``build/kernels/`` at the root of the checkout, at first use, then
loaded with ``ctypes``. A library's file name carries a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused. All sources compile in parallel, one ``nvcc`` each.

No PyTorch header is included: such a build takes minutes, a plain C
one seconds. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(name):
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "{}-{}.so".format(name, digest.hexdigest()[:16]))


def build_all():
    """Compile every source whose library is missing, all at once.
    Returns {name: path}. Raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in _sources()}
    jobs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = "{}.tmp{}".format(path, os.getpid())
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC_DIR, name + ".cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, name + ".log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            failed.append("{}:\n{}".format(name, out))
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            path = build_all()[name]
        lib = _libs[name] = ctypes.CDLL(path)
    return lib


def check(err, what):
    """Raise if a launch function returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError("{} failed: cudaError_t {}".format(what, err))
