"""Build and load the ``_dvsg_torch_native`` host extension (staging.cpp).

utils/staging.py builds it at first use; to build it ahead of time:

    python -m dvsg_tpu_torch.native.build

It compiles with ``$CXX`` (default ``g++``) into ``build/dvsg_tpu_torch/``
at the root of the checkout, under a name hashed from the source, the flags
and the host (``-march=native`` code runs only on the kind of CPU that
built it), so an edited source is rebuilt and an unchanged one is loaded as
it is. The library is written under a temporary name and moved into place,
so processes that build at once never load a half-written file. A failed
build raises with the compiler's stderr.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "staging.cpp")
MODULE = "_dvsg_torch_native"
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "dvsg_tpu_torch")
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")


def ext_path() -> str:
    """Where the library of the current source, flags and host lives."""
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    digest.update(os.uname().nodename.encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR,
                        f"{MODULE}-{digest.hexdigest()[:12]}{suffix}")


def build(verbose: bool = False) -> str:
    """Compile the extension unless it is built; returns its path."""
    out = ext_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *FLAGS,
           f"-I{sysconfig.get_path('include')}", SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the staging extension failed (exit "
                           f"{res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    if verbose:
        print(f"built {out}")
    return out


def load():
    """The extension module, built first if needed."""
    path = build()
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    spec = importlib.util.spec_from_file_location(MODULE, path,
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    build(verbose=True)
