#!/bin/bash
# Static-analysis gate of the PyTorch/CUDA port (minivideo_tpu_torch), the
# port's counterpart of tools/lint.sh, with JAX and the JAX package
# blocked throughout: compileall, the three native libraries built with
# the port's own g++ argv (native.cxx_argv) at -Werror, with --cuda every
# csrc/*.cu compiled with ops/kernels.py's nvcc argv at -Werror
# all-warnings, import health of every module, the ASan gate
# (tools/asan_check_torch.sh), and a fresh-venv editable install whose
# mvt-* console scripts must run.
#
# Usage: bash tools/lint_torch.sh [--cuda]
set -eo pipefail
cd "$(dirname "$0")/.."

CUDA=0
for a in "$@"; do
    case "$a" in
        --cuda) CUDA=1 ;;
        *) echo "usage: bash tools/lint_torch.sh [--cuda]"; exit 2 ;;
    esac
done
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
# packages that stand in for JAX and the JAX package and refuse to import,
# for the processes (console scripts) that cannot block them themselves
for name in jax jaxlib minivideo_tpu; do
    mkdir -p "$TMP/block/$name"
    echo "raise ImportError('$name is blocked in the port lint')" \
        > "$TMP/block/$name/__init__.py"
done
# run python with JAX and the JAX package blocked in sys.modules
blocked_python() {
    python -c "import sys
for n in ('jax', 'jaxlib', 'minivideo_tpu'):
    sys.modules[n] = None
sys.argv = sys.argv[1:]
exec(compile(open(sys.argv[0]).read(), sys.argv[0], 'exec'))" "$@"
}

echo "== python syntax (compileall)"
python -m compileall -q minivideo_tpu_torch tests/test_torch_*.py \
    tests/torch_port_helpers.py chip_smoke.py tools/asan_exercise_torch.py

echo "== native builds, the port's argv, warnings as errors"
cat > "$TMP/native.py" <<'EOF'
import os, subprocess, sys
from minivideo_tpu_torch import native
out = sys.argv[1]
procs = {name: subprocess.Popen(
    native.cxx_argv(os.path.join(out, f"lib{name}.so"), srcs, libs)
    + ["-Werror"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    text=True) for name, (srcs, libs) in native.libraries().items()}
bad = []
for name, p in procs.items():
    log = p.communicate(timeout=600)[0]
    print(f"{name}: {' '.join(p.args)}: exit {p.returncode}")
    if p.returncode != 0:
        print(log)
        bad.append(name)
sys.exit(1 if bad else 0)
EOF
blocked_python "$TMP/native.py" "$TMP"

if [ "$CUDA" = 1 ]; then
    echo "== CUDA sources, ops/kernels.py's nvcc argv, -Werror all-warnings"
    cat > "$TMP/cuda.py" <<'EOF'
import os, shutil, subprocess, sys
from minivideo_tpu_torch.ops import kernels
out = sys.argv[1]
argvs = [kernels.compile_argv(src, os.path.join(out, f"{i}.o"))
         + ["-Werror", "all-warnings"] for i, src in enumerate(kernels.SOURCES)]
nvcc = argvs[0][0]
if not (os.path.exists(nvcc) or shutil.which(nvcc)):
    sys.exit(f"--cuda: no nvcc ({nvcc}): the CUDA sources cannot be linted")
procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True) for a in argvs]
bad = []
for src, p in zip(kernels.SOURCES, procs):
    log = p.communicate(timeout=900)[0]
    print(f"{os.path.basename(src)}: {' '.join(p.args)}: exit "
          f"{p.returncode}")
    if p.returncode != 0:
        print(log)
        bad.append(src)
sys.exit(1 if bad else 0)
EOF
    blocked_python "$TMP/cuda.py" "$TMP"
else
    echo "== CUDA sources not compiled (no --cuda)"
fi

echo "== import health"
cat > "$TMP/imports.py" <<'EOF'
import importlib, pkgutil
import minivideo_tpu_torch
bad = []
for m in pkgutil.walk_packages(minivideo_tpu_torch.__path__,
                               "minivideo_tpu_torch."):
    try:
        importlib.import_module(m.name)
    except Exception as e:  # noqa: BLE001 - every failure is listed
        bad.append((m.name, repr(e)))
assert not bad, bad
print("all minivideo_tpu_torch modules import cleanly")
EOF
blocked_python "$TMP/imports.py"

echo "== AddressSanitizer gate (the port's libraries, valid and mutated inputs)"
bash tools/asan_check_torch.sh 3 2>&1 | tail -3

echo "== packaging: fresh-venv editable install and the mvt-* scripts"
# offline: a .pth line gives the venv the parent environment's packages
# (numpy, torch, setuptools, pip); --no-index fetches nothing and
# --no-deps skips the JAX dependency of the JAX package
VENV="$TMP/venv"
python -m venv --without-pip "$VENV"
PARENT_SITE=$(python -c "import numpy, os; print(os.path.dirname(os.path.dirname(numpy.__file__)))")
VENV_SITE=$("$VENV/bin/python" -c "import site; print(site.getsitepackages()[0])")
echo "$PARENT_SITE" > "$VENV_SITE/parent_env.pth"
"$VENV/bin/python" -m pip install -q -e . --no-build-isolation --no-index \
    --no-deps
export PYTHONPATH="$TMP/block"
for s in mvt-thumbnail mvt-extract mvt-analyse; do
    "$VENV/bin/$s" --help > /dev/null
    echo "$s --help: ok"
done
cd "$TMP"
"$VENV/bin/python" - <<'EOF'
import os, subprocess, sys
from minivideo_tpu_torch.testing.h264enc import make_stream
clip = os.path.abspath("clip.264")
with open(clip, "wb") as f:
    f.write(make_stream(width_mbs=4, height_mbs=3, n_pictures=1, seed=5,
                        mb_kinds=("i16",), density=0.2, allow_pcm=False))
exe = os.path.join(os.path.dirname(sys.executable), "mvt-thumbnail")
r = subprocess.run([exe, "-i", clip, "-o", "thumbs", "-f", "bmp",
                    "--device", "cpu"], capture_output=True, text=True)
assert r.returncode == 0, r.stderr
out = r.stdout.strip()
assert os.path.getsize(out) > 54, out
print("mvt-thumbnail run: ok,", os.path.basename(out))
EOF

echo "lint_torch: OK"
