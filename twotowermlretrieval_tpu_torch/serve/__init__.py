from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex  # noqa: F401
from twotowermlretrieval_tpu_torch.serve.inferencer import QueryInferencer  # noqa: F401
from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine  # noqa: F401
from twotowermlretrieval_tpu_torch.serve.simple_hybrid import SimpleHybridRetriever  # noqa: F401
