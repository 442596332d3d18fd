"""Device tables: the card's peak rates and memory, and the bytes of
training state a parameter holds (the counterpart of the JAX package's
``training/memory.py`` tables, for NVIDIA cards).

One table for the port: the bench tools (``tools/``), the runtime lint's
mfu/mbu peaks (``runtime/lint/compilecheck.py``) and ``chip_smoke.py``
read it.  Keys are substrings of the lower-cased device name
(``torch.cuda.get_device_name``); a name the table does not know gives
None, and so does the CPU.

The rates are NVIDIA's data sheet for the H100 SXM at its full 700-W
limit, dense (no sparsity): 989 TFLOP/s bf16 on the tensor cores, 495
TF32, 67 f32 outside them; 3.35 TB/s of HBM3 and 80 GB of it.  A card
set below 700 W (``nvidia-smi``'s ``power.limit``) runs slower under
load; the tools print the limit beside every figure.

What waits (ROADMAP Queue 1 step 8c): the activation model
(``decoder_activation_bytes``, calibrated on a TPU v5e) and
``plan_train_memory``.  Until then the bench tools' memory guard counts
the train state alone against the card's free memory.
"""

from __future__ import annotations

from typing import Optional

#: Data-sheet figures by device-name substring: peak TFLOP/s by dtype,
#: HBM bytes/s and HBM bytes.
DEVICE_TABLE = {
    "h100": {"tflops": {"bf16": 989.0, "fp16": 989.0, "tf32": 495.0,
                        "f32": 67.0},
             "hbm_bytes_per_sec": 3.35e12,
             "hbm_bytes": 80e9},
}

#: The H100's row, for code that reasons about the card it was written
#: for (kernel bounds in ``tools/roofline.py`` and ``chip_smoke.py``).
H100 = DEVICE_TABLE["h100"]

#: Bytes of training state a parameter holds under the port's adam
#: recipe: the f32 master, its f32 gradient and two f32 moments (the
#: compute dtype's copy is cast per product and not kept).
STATE_BYTES_PER_PARAM = 16


def _row(device_name: str) -> Optional[dict]:
    name = device_name.lower()
    for sub, row in DEVICE_TABLE.items():
        if sub in name:
            return row
    return None


def peak_tflops(device_name: str, dtype: str = "bf16") -> Optional[float]:
    """Dense peak TFLOP/s of ``dtype`` ("bf16", "fp16", "tf32", "f32") on
    the named card; None when unknown."""
    row = _row(device_name)
    return None if row is None else row["tflops"].get(dtype)


def hbm_bandwidth_bytes_per_sec(device_name: str) -> Optional[float]:
    row = _row(device_name)
    return None if row is None else row["hbm_bytes_per_sec"]


def hbm_budget_bytes(device_name: str) -> Optional[float]:
    """The card's memory by its data sheet; None when unknown."""
    row = _row(device_name)
    return None if row is None else row["hbm_bytes"]
