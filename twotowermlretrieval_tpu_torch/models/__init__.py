from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, init_rnn_encoder, rnn_encode  # noqa: F401
from twotowermlretrieval_tpu_torch.models.transformer import (  # noqa: F401
    TransformerSpec,
    init_transformer_encoder,
    transformer_encode,
)
from twotowermlretrieval_tpu_torch.models.two_tower import (  # noqa: F401
    TwoTowerSpec,
    encode_document,
    encode_query,
    init_two_tower,
    params_from_jax,
    two_tower_forward,
)
from twotowermlretrieval_tpu_torch.models.losses import (  # noqa: F401
    combined_loss,
    in_batch_softmax_loss,
    triplet_loss_cosine,
)
