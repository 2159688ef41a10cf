from twotowermlretrieval_tpu_torch.train.artifacts import (  # noqa: F401
    collect_unique_documents,
    load_artifacts,
    save_inference_artifacts,
)
