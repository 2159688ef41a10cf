from twotowermlretrieval_tpu_torch.ops.tfidf import (  # noqa: F401
    TfidfVectorizer,
    cosine_similarity,
    hybrid_blend,
)


def launch_counts() -> dict:
    """Every CUDA kernel's launches in this process, counted by its wrapper
    where it launches (a wrapper given CPU tensors runs its plain version
    and counts nothing)."""
    from twotowermlretrieval_tpu_torch.ops import adam, attention, rnn_scan, topk

    return {"rnn_fwd": rnn_scan.rnn_layer_fwd.launches,
            "rnn_bwd": rnn_scan.rnn_layer_bwd.launches,
            "segmax": topk.segmax.launches,
            "segmax_s8": topk.segmax_s8.launches,
            "segmax_int8": topk.segmax_int8.launches,
            "topk_stream": topk.topk_stream.launches,
            "topk_stream_int8": topk.topk_stream_int8.launches,
            "attention_fwd": attention.attention_fwd.launches,
            "attention_bwd": attention.attention_bwd.launches,
            "adam": adam.clip_and_adam.launches}
