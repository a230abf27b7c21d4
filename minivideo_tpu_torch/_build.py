"""Build the port's shared libraries from the sources in the checkout.

Each library is compiled at first use into `_build/` inside the package
(listed in .gitignore), under a name that carries a hash of its sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  A failed or timed-out build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# compiler output of the builds this process ran, by library name
LOGS: dict = {}


def build_shared(name: str, sources, cmd, timeout: int = 300) -> str:
    """Compile `sources` into `_build/lib<name>-<hash>.so` unless present.

    `cmd(out_path)` returns the compiler argv writing to out_path.  The
    hash covers the sources, every header beside them and the argv, so
    any change rebuilds.  Concurrent builds (test workers) each write
    a private temporary file and rename it into place atomically.
    """
    h = hashlib.sha256()
    dirs = sorted({os.path.dirname(s) for s in sources})
    deps = sorted(set(sources) | {
        os.path.join(d, f) for d in dirs for f in os.listdir(d)
        if f.endswith((".h", ".cuh"))})
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cmd("OUT")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(cmd(tmp), capture_output=True, text=True,
                           timeout=timeout)
        LOGS[name] = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (exit {r.returncode}):\n"
                f"{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
