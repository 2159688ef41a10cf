from twotowermlretrieval_tpu_torch.data.loader import TripletBuilder, load_datasets  # noqa: F401
from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, Batch  # noqa: F401
from twotowermlretrieval_tpu_torch.data.glove import (  # noqa: F401
    load_embedding_table,
    parse_glove_txt,
)
