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


_BLOCKED_PROBE = r"""
import sys
for name in ("transformers", "safetensors", "tensorflow"):
    sys.modules[name] = None        # any import of them raises
import importlib, pkgutil
import torch
import tensorflow_train_distributed_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from tensorflow_train_distributed_torch.models import hf_io, import_hf
got = {}
for fmt in ("safetensors", "bin"):
    reader = hf_io.CheckpointReader(sys.argv[1] + "/" + fmt)
    assert reader.format == fmt, reader.format
    cfg, params = import_hf.import_llama(sys.argv[1] + "/" + fmt,
                                         device="cpu", dtype=torch.float32)
    got[fmt] = params
assert all(torch.equal(got["bin"][k], v)
           for k, v in got["safetensors"].items())
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("transformers", "safetensors",
                                     "tensorflow", "jax", "flax"))
print(len(names), len(got["bin"]), cfg.num_layers, bad)
"""


def test_port_loads_hf_checkpoints_without_transformers(tmp_path):
    """The card's machine has no transformers, safetensors or tensorflow:
    with all three blocked, a fresh interpreter imports every port module
    and loads a tiny HF directory in safetensors and in .bin through
    ``import_hf``, the two equal."""
    import torch
    import transformers

    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=32)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.save_pretrained(tmp_path / "safetensors")
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_PROBE,
                           str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, tensors, layers, bad = proc.stdout.strip().split(" ", 3)
    assert int(count) >= 10 and int(tensors) == 21 and int(layers) == 2
    assert bad == "[]"
