"""The training CLI of slice 2, now the launcher under its old name
(``launch.py`` has the flags, the trainer's construction and the run).

  python -m tensorflow_train_distributed_torch.train --config llama_125m_lm --steps 20
  python -m tensorflow_train_distributed_torch.train --config llama_tiny_sft \\
      --steps 3 --device cpu
"""

import sys

from tensorflow_train_distributed_torch.launch import (  # noqa: F401
    build_parser,
    main,
    make_trainer,
)

if __name__ == "__main__":
    sys.exit(main())
