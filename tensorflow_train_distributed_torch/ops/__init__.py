"""Hot ops: the attention dispatch, the hand-written kernels' entry
points and the row-sharded embeddings (the JAX ``ops`` package's
exports; ``fused_cross_entropy`` is the K3 kernel's
``kernels.cross_entropy``)."""

from tensorflow_train_distributed_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
    multihead_attention_kernel,
)
from tensorflow_train_distributed_torch.ops.embedding import (  # noqa: F401
    EmbeddingCollection,
    FeatureSpec,
    TableSpec,
    sharded_lookup,
)
from tensorflow_train_distributed_torch.ops.kernels import (  # noqa: F401
    cross_entropy as fused_cross_entropy,
    rms_norm,
)
