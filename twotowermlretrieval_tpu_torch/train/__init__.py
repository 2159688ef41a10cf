from twotowermlretrieval_tpu_torch.train.artifacts import (  # noqa: F401
    collect_unique_documents,
    load_artifacts,
    save_inference_artifacts,
)
from twotowermlretrieval_tpu_torch.train.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    merge_params,
    partition_params,
)
from twotowermlretrieval_tpu_torch.train.evaluators import (  # noqa: F401
    BatchEvaluator,
    CorpusEvaluator,
    TestEvaluator,
)
from twotowermlretrieval_tpu_torch.train.metrics import MetricLogger  # noqa: F401
