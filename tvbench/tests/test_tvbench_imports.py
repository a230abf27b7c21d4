"""The import check: top-level names compared whole."""

import subprocess
import sys

from tvbench.check import forbidden_modules
from tvbench.inputs import ROOT


def test_top_level_names_compared_whole():
    assert forbidden_modules({"minivideo_tpu_torch": 1,
                              "minivideo_tpu_torch.bench": 1,
                              "jaxtyping": 1, "numpy": 1}) == []
    assert forbidden_modules({"jax.numpy": 1, "minivideo_tpu.ops": 1,
                              "flax": 1, "jaxlib": 1, "numpy": 1}) == \
        ["flax", "jax.numpy", "jaxlib", "minivideo_tpu.ops"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                  'minivideo_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from tvbench import inputs, run, check\n"
        "from tvbench.tests.conftest import run_tiny\n"
        f"out, _ = run_tiny('batch', {str(tmp_path)!r})\n"
        "assert out['correct'], out\n"
        "bad = check.forbidden_modules()\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-3000:]


def test_no_card_exits_without_a_result(tmp_path):
    r = subprocess.run([sys.executable, "-m", "tvbench.run", "--workload",
                        "thumb-mp4-jpg-b64", "--seed", str(2**34),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin",
                            "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_it_exits_without_a_result(tmp_path):
    import shutil
    shutil.copytree(f"{ROOT}/tvbench", tmp_path / "tvbench")
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "-m", "tvbench.run", "--workload",
                        "thumb-mp4-jpg-b64", "--seed", "5", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "minivideo_tpu_torch" in r.stderr
