from twotowermlretrieval_tpu_torch.ops.tfidf import (  # noqa: F401
    TfidfVectorizer,
    cosine_similarity,
    hybrid_blend,
)
