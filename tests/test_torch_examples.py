"""The port's demos (fastdnn_tpu_torch/examples/*.py) on the CPU, after
tests/test_examples.py, and the guards of this slice's modules.

Each demo runs as a user runs it, `python -m fastdnn_tpu_torch.examples.
<name> --device cpu`, in its own process (all four at once); each must
exit 0 and print the load-bearing line that tests/test_examples.py looks
for in its JAX namesake's output (the demos assert their own claims, so a
broken check fails here too).  The guards: the registry, the profiler, the
autotuner and the demos import neither JAX nor the JAX package (they
import with JAX blocked), and without a card each of their entry points
raises on --device cuda instead of running on the CPU.
"""

import importlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: demo -> the line its JAX namesake's test requires
EXAMPLES = {
    "pipeline": "server stats",
    "mesh_scoring": "masked   max |mesh - single-device|",
    "lazy_decoder": "max |batch - streaming| = 0.00e+00",
    "beam_decoder": "word sequences agree: True",
}
MODULES = ["tuning", "cli.profile", "cli.autotune"] + [
    f"examples.{name}" for name in ("_common", *EXAMPLES)]


def _run(name: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", f"fastdnn_tpu_torch.examples.{name}", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(max_workers=len(EXAMPLES)) as pool:
        return dict(zip(EXAMPLES, pool.map(_run, EXAMPLES)))


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs(runs, name):
    proc = runs[name]
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    assert EXAMPLES[name] in proc.stdout, f"{name} output missing {EXAMPLES[name]!r}:\n" \
        f"{proc.stdout[-2000:]}"


def test_examples_read_their_frames_from_a_file(tmp_path):
    """--features takes a reference-format file; the demo scores what it
    holds (here 70 frames of 432 dims, a width the nets' input admits)."""
    import numpy as np

    from fastdnn_tpu_torch import write_features

    path = tmp_path / "f.bin"
    write_features(np.random.default_rng(4).standard_normal((70, 432), dtype=np.float32), path)
    from fastdnn_tpu_torch.examples import pipeline

    assert pipeline.main(["--device", "cpu", "--features", str(path)]) == 0


def _path(module: str) -> str:
    return os.path.join(REPO, "fastdnn_tpu_torch", *module.split(".")) + ".py"


class TestGuards:
    @pytest.mark.parametrize("module", MODULES)
    def test_no_jax_in_the_module(self, module):
        text = open(_path(module)).read()
        for banned in ("import jax", "from jax", "ml_dtypes", "import fastdnn_tpu\n",
                       "from fastdnn_tpu.", "from fastdnn_tpu import"):
            assert banned not in text, f"{module}: {banned!r}"

    def test_modules_import_with_jax_blocked(self):
        code = (
            "import sys\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module('fastdnn_tpu_torch.' + m)\n"
            "assert not any(m == 'fastdnn_tpu' or m.startswith(('fastdnn_tpu.', 'jax'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=REPO, timeout=300)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr

    @pytest.mark.parametrize("module,argv", [
        ("cli.profile", ["trace"]),
        ("cli.autotune", ["--batch", "128"]),
        *[(f"examples.{name}", []) for name in EXAMPLES],
    ])
    def test_cuda_without_a_card_raises(self, module, argv):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal without a card")
        mod =importlib.import_module(f"fastdnn_tpu_torch.{module}")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([*argv, "--device", "cuda"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)  # cuda is the default
