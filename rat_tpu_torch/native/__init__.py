"""Native host encoders (C++), the port's copy of rat_tpu.native.

``fastenc`` (fastenc.cpp) runs the feature pipeline's hot loops on
large columns: vocabulary lookup of string categories, sequence
tokenize-and-pad, token counting. It is a CPython extension, compiled
at first use (never at import) with ``g++ -O2 -shared -fPIC -std=c++17``
against the interpreter's headers into
``build/native/fastenc-<hash of source and flags><EXT_SUFFIX>`` at the
root of the checkout, an edited source rebuilding, and loaded under the
name ``rat_tpu_torch.native.fastenc`` by its file path, so that it can
never be confused with the JAX package's module of the same base name.
Without a compiler or ``Python.h`` the build fails once, its error is
logged at WARNING, and the Python paths run: their outputs are equal.
"""

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import shutil
import subprocess
import sys
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fastenc.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
MODULE_NAME = "rat_tpu_torch.native.fastenc"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

#: the loaded extension module, or None before a successful build()
fastenc = None
_failed = []


def python_header():
    """Path of the interpreter's ``Python.h`` (which may not exist)."""
    return os.path.join(sysconfig.get_paths()["include"], "Python.h")


def _flags():
    return CXX_FLAGS + ["-I" + sysconfig.get_paths()["include"]]


def library_path():
    """Where the extension for this source and these flags lives."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_flags()).encode())
    return os.path.join(BUILD_DIR, "fastenc-{}{}".format(
        digest.hexdigest()[:16], sysconfig.get_config_var("EXT_SUFFIX")))


def _compile(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.tmp{}".format(path, os.getpid())
    cxx = shutil.which("g++") or "g++"
    try:
        out = subprocess.run([cxx] + _flags() + [SOURCE, "-o", tmp],
                             capture_output=True, text=True)
    except OSError as e:
        return str(e)
    if out.returncode != 0:
        return out.stdout + out.stderr
    os.replace(tmp, path)
    return None


def build():
    """Compile (if needed) and load the extension; returns True when
    ``fastenc`` is usable. A failure is logged once and remembered."""
    global fastenc
    if fastenc is not None:
        return True
    if _failed:
        return False
    path = library_path()
    error = None if os.path.exists(path) else _compile(path)
    if error is None:
        try:
            loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, path)
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path,
                                                          loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
        except ImportError as e:
            error = str(e)
    if error is not None:
        _failed.append(error)
        logging.warning("fastenc: the native encoder did not build (%s); the "
                        "Python encoders run instead:\n%s", python_header(),
                        error.strip()[-2000:])
        return False
    sys.modules[MODULE_NAME] = fastenc = module
    return True
