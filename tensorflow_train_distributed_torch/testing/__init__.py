"""Test infrastructure: multi-process clusters on one host (counterpart
of the JAX package's ``testing/``)."""

from tensorflow_train_distributed_torch.testing.multiprocess import (  # noqa: F401
    MultiProcessRunner,
    ProcessResult,
    TimeoutError_,
    UnexpectedExitError,
    free_ports,
    tf_config_env,
)
