#!/bin/bash
# AddressSanitizer gate for the native libraries of the PyTorch/CUDA port
# (minivideo_tpu_torch/native/src: the entropy parser, the demuxer and
# the picture encoders), the port's counterpart of tools/asan_check.sh.
# Builds one instrumented library from the three sources, proves that the
# gate sees an overflow (tools/asan_exercise_torch.py --self-check must
# abort with an ASan report), then drives every native entry point of the
# port over valid and mutated inputs through that library.
#
# Usage: bash tools/asan_check_torch.sh [rounds]
set -e
cd "$(dirname "$0")/.."

TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
ASAN_SO="$TMP/libmvt_native_asan.so"
SRC=minivideo_tpu_torch/native/src
echo "== building the ASan-instrumented library of the port"
g++ -O1 -g -fsanitize=address -fno-omit-frame-pointer -fPIC -std=c++17 \
    -pthread -shared -o "$ASAN_SO" \
    "$SRC/entropy.cc" "$SRC/demux.cc" "$SRC/export.cc" -lz

LIBASAN=$(g++ -print-file-name=libasan.so)
test -f "$LIBASAN" || { echo "asan: no libasan.so ($LIBASAN)"; exit 1; }
# Leak detection off: the interpreter holds allocations at exit by
# design; the gate is after overflows and use-after-free in the
# libraries.  PYTHONMALLOC=malloc puts Python's own small buffers (a
# short RBSP `bytes`) on malloc, where ASan sees past their ends.
run() {
    LD_PRELOAD="$LIBASAN" \
    ASAN_OPTIONS=detect_leaks=0:abort_on_error=1 \
    PYTHONMALLOC=malloc \
    MINIVIDEO_TPU_TORCH_NATIVE_LIB="$ASAN_SO" \
    python tools/asan_exercise_torch.py "$@"
}

echo "== negative control: an overflow the gate must catch"
set +e
run --self-check > "$TMP/control.log" 2>&1
rc=$?
set -e
if [ "$rc" -eq 0 ] || ! grep -q "ERROR: AddressSanitizer: heap-buffer-overflow" \
        "$TMP/control.log"; then
    cat "$TMP/control.log"
    echo "asan: FAILED: the negative control did not abort with an ASan" \
         "report (exit $rc)"
    exit 1
fi
echo "negative control aborted (exit $rc): $(grep -m1 'ERROR: AddressSanitizer' "$TMP/control.log")"

echo "== exercising the port's native libraries under ASan ($LIBASAN)"
run "${1:-3}"

echo "asan: OK"
