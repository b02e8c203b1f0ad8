"""The PyTorch port imports torch and never jax: every module of the package
(the fourth slice's `device`, `models.fm`, `models.multichannel`,
`ops.filters` and `stream.*`, the ninth slice's `parallel.*` and
`models.geo`, the tenth slice's `parallel.distributed`, and the eleventh
slice's `ops.peaks_extra` and `utils.profiling` among them), and
the chip smoke script, whose `--worker` mode runs the two-process mesh on
the card, import in a fresh interpreter without loading jax."""
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import directdemod_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
new = {"directdemod_tpu_torch." + m for m in (
    "device", "models.fm", "models.multichannel", "ops.filters", "stream.api",
    "stream.checkpoint", "stream.pipeline", "stream.plan", "models.geo",
    "parallel", "parallel.am", "parallel.correlate", "parallel.distributed",
    "parallel.dryrun", "parallel.iir", "parallel.mesh", "parallel.sharded",
    "ops.peaks_extra", "utils.profiling")}
assert new <= set(names), sorted(new - set(names))
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("directdemod_tpu.") or m == "directdemod_tpu"
               for m in sys.modules)
print(len(names))
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 54      # every slice was walked


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device the smoke script exits non-zero and prints no
    result line (the CPU never stands in for the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
