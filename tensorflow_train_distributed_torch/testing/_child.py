"""Child bootstrap for ``MultiProcessRunner`` workers.

Argv: ``target("module:function") rank payload_json``.  Pins torch to
the runner's thread count, joins the gloo group the runner's env
describes (``runtime.distributed`` resolution order), runs the worker
function, and prints its JSON result on stdout behind ``TTD_RESULT:``.
"""

import importlib
import json
import os
import sys


def main() -> int:
    target, rank_s, payload_json = sys.argv[1], sys.argv[2], sys.argv[3]
    rank = int(rank_s)
    payload = json.loads(payload_json)

    import torch

    torch.set_num_threads(int(os.environ.get("TTD_TEST_THREADS", "1")))
    if os.environ.get("TTD_TEST_INIT_DISTRIBUTED") == "1":
        from tensorflow_train_distributed_torch.runtime.distributed import (
            initialize_distributed,
        )

        initialize_distributed(device="cpu")

    mod_name, _, fn_name = target.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    try:
        result = fn(rank, **payload)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    print("TTD_RESULT:" + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
