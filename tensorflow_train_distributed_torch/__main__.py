"""``python -m tensorflow_train_distributed_torch`` → the launcher."""

import sys

from tensorflow_train_distributed_torch.launch import main

if __name__ == "__main__":
    sys.exit(main())
