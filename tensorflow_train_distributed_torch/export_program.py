"""Export a trained model's inference as a ``torch.export`` program: the
counterpart of the JAX package's ``export_tf.py``.

The JAX package hands a trained model on as a TensorFlow SavedModel of
the task's ``predict_fn``; the port's machines have no TensorFlow, so the
artifact here is an ``ExportedProgram`` of ``predict_fn`` saved with
``torch.export.save``: one file that ``torch.export.load`` reads back
anywhere PyTorch runs, with no import of this package.  The parameters
and the model state (BatchNorm's running statistics) are the program's
state (its parameters and buffers), not constants folded into the graph.
With ``batch_polymorphic`` the leading dimension of every feature is one
``torch.export.Dim``, so one artifact serves any batch size.

The trace runs on the CPU (the JAX tool's ``--platform cpu`` default), in
f32 and in eval mode, so what is exported is each kernel's plain
PyTorch version: a kernel launched through ctypes cannot be traced.  The
loaded program runs on the card as plain PyTorch operators.

  python -m tensorflow_train_distributed_torch.export_program \\
      --config mnist --checkpoint-dir ck --out mnist.pt2
  (without --checkpoint-dir: random weights from seed 0, a signature
  smoke test)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn


class _Predict(nn.Module):
    """``task.predict_fn`` as a module that owns the task's model, so its
    parameters and buffers are the exported program's state."""

    def __init__(self, task):
        super().__init__()
        self.model = task.model
        self._task = task

    def forward(self, batch: dict) -> torch.Tensor:
        return self._task.predict_fn(batch)


def export_program(task, sample_batch: dict, out_path, *,
                   batch_polymorphic: bool = True):
    """Write ``task.predict_fn`` (its model in eval mode, on the CPU) as
    an ``ExportedProgram`` to ``out_path``; returns the program.

    ``sample_batch`` fixes the signature (feature names, trailing shapes,
    dtypes); with ``batch_polymorphic`` the batch dimension is symbolic
    (the sample needs at least 2 rows: torch.export specializes 0 and
    1)."""
    if not hasattr(task, "predict_fn"):
        raise ValueError(
            f"{type(task).__name__} has no predict_fn; nothing to export")
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
             sample_batch.items()}
    module = _Predict(task).eval()
    dynamic = None
    if batch_polymorphic:
        b = torch.export.Dim("batch")
        dynamic = ({k: {0: b} for k in batch},)
    with torch.no_grad():
        program = torch.export.export(module, (batch,),
                                      dynamic_shapes=dynamic)
    torch.export.save(program, str(out_path))
    return program


def load_program(path, device="cuda") -> nn.Module:
    """The saved program as a callable inference module on ``device``
    (its weights frozen).  The trace recorded the CPU in the graph (each
    dtype cast asserts its input's device), so the program moves as a
    whole (``move_to_device_pass``), not only its state."""
    from torch.export.passes import move_to_device_pass

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    program = move_to_device_pass(torch.export.load(str(path)), dev)
    return program.module().requires_grad_(False)


SAMPLE_ROWS = 2      # the fewest rows torch.export does not specialize


def export_from_registry(config_name: str, checkpoint_dir, out_path):
    """A registry config and the newest checkpoint the port's launcher
    wrote in ``checkpoint_dir`` → an exported program at ``out_path``.
    The restore reads the parameters and the model state (BatchNorm's
    running statistics), not the optimizer state, so any optimizer's run
    exports alike; ``checkpoint_dir=None`` exports random weights from
    seed 0.  The signature's sample is ``SAMPLE_ROWS`` rows of the
    config's dataset: the batch dimension is symbolic, so the rows traced
    do not shape the program."""
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.data.datasets import get_dataset
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
    )
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    try:
        entry = registry.get_entry(config_name)
    except ValueError as e:
        raise SystemExit(str(e))
    source = get_dataset(entry["dataset"], num_examples=SAMPLE_ROWS,
                         **entry["dataset_kwargs"])
    sample = next(iter(HostDataLoader(source, DataConfig(
        global_batch_size=SAMPLE_ROWS))))
    task = registry.make_task(entry, device="meta")
    if checkpoint_dir is not None:
        mgr = CheckpointManager(str(checkpoint_dir))
        params = mgr.restore_params()
        if params is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        names = convert.model_state_names(task.model)
        state = {names[k]: v for k, v in mgr.restore_model_state().items()}
        if set(state) != set(names.values()):
            raise ValueError(
                f"the checkpoint's model state {sorted(state)} is not "
                f"the model's {sorted(names.values())}")
        params.update(state)
    else:
        params = convert.init_params(
            task.config, torch.Generator().manual_seed(0), device="cpu")
    task.model.load_state_dict(
        {k: v.to(device="cpu", dtype=torch.float32)
         for k, v in params.items()}, strict=True, assign=True)
    return export_program(task, sample, out_path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--out", required=True,
                   help="path of the program file (torch.export.save)")
    args = p.parse_args(argv)
    try:
        export_from_registry(args.config, args.checkpoint_dir, args.out)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(str(e))
    print(f"exported program written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
