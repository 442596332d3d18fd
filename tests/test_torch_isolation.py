"""The port imports torch and nothing of JAX: every module of
``tensorflow_train_distributed_torch`` (and ``chip_smoke.py``) imports in
a fresh interpreter without loading ``jax``, ``flax`` or the JAX
package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import tensorflow_train_distributed_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "tensorflow_train_distributed_tpu"))
print(len(names), bad)
"""


def test_port_modules_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 10
    assert bad == "[]"
