"""Build the port's shared libraries from the sources in the checkout.

Each library is compiled at first use into `_build/` inside the package
(listed in .gitignore), under a name that carries a hash of its sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  A failed or timed-out build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# compiler output of the builds this process ran, by library name
LOGS: dict = {}


def _run_all(name, argvs, timeout):
    """Run every argv at once; raise if any fails or outlives `timeout`."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    LOGS[name] = LOGS.get(name, "") + "".join(outs)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"building {name} failed (exit "
                               f"{p.returncode}):\n{out[-4000:]}")


def build_shared(name: str, sources, cmd, timeout: int = 300,
                 compile_cmd=None, binary: bool = False) -> str:
    """Compile `sources` into `_build/lib<name>-<hash>.so` (with `binary`,
    the executable `_build/<name>-<hash>`) unless present.

    `cmd(out_path, inputs)` returns the argv that writes the library to
    out_path from `inputs`: the sources themselves or, with
    `compile_cmd(src, obj)`, the objects of one compiler process per
    source, all started together.  The hash covers the sources, every
    header beside them and the argvs, so any change rebuilds.
    Concurrent builds (test workers) each write private temporary files
    and rename the library into place atomically.
    """
    h = hashlib.sha256()
    dirs = sorted({os.path.dirname(s) for s in sources})
    deps = sorted(set(sources) | {
        os.path.join(d, f) for d in dirs for f in os.listdir(d)
        if f.endswith((".h", ".cuh"))})
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cmd("OUT", sources)).encode())
    if compile_cmd is not None:
        h.update(" ".join(compile_cmd("SRC", "OBJ")).encode())
    tag = f"{name}-{h.hexdigest()[:16]}"
    out = os.path.join(BUILD_DIR, tag if binary else f"lib{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    tmp = os.path.join(tmpdir, "lib.so")
    LOGS[name] = ""
    try:
        inputs = list(sources)
        if compile_cmd is not None:
            inputs = [os.path.join(tmpdir, f"{i}.o")
                      for i in range(len(sources))]
            _run_all(name, [compile_cmd(s, o)
                            for s, o in zip(sources, inputs)], timeout)
        _run_all(name, [cmd(tmp, inputs)], timeout)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out
