"""Typed configuration for the two-tower retrieval framework (PyTorch port).

A copy of the JAX package's ``Config``: same fields, same JSON keys, so a
config.json written by either package loads in the other.

The reference uses a flat JSON dict with UPPER_SNAKE keys loaded by
``load_config`` (ref: backend/main.py:76-79, backend/config.json:1-25) and
re-persists it — enriched with runtime-derived VOCAB_SIZE/EMBED_DIM — next to
the exported artifacts (ref: backend/main.py:101-106) so that serving can
rebuild the exact architecture (ref: backend/query_inferencer.py:36-49).

We keep that on-disk contract (same key names, JSON round-trip, runtime keys
persisted with artifacts) but back it with a typed, validated dataclass and
add the TPU-specific knobs the reference has no concept of: static sequence
lengths / bucketing (jit-friendly shapes), dtype policy, mesh axes, loss
selection, and in-batch-negative training.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


# Map between reference JSON keys and dataclass fields. Every reference key
# from backend/config.json:1-25 appears here so existing configs load as-is.
_KEY_TO_FIELD = {
    # data
    "TRAIN_DATASET_PATH": "train_dataset_path",
    "VAL_DATASET_PATH": "val_dataset_path",
    "TEST_DATASET_PATH": "test_dataset_path",
    "EMBEDDINGS_PATH": "embeddings_path",
    "WORD_TO_IDX_PATH": "word_to_idx_path",
    "SUBSAMPLE_RATIO": "subsample_ratio",
    "NUM_TRIPLETS_PER_QUERY": "num_triplets_per_query",
    "TRAINING_MODE": "training_mode",
    # model
    "VOCAB_SIZE": "vocab_size",
    "EMBED_DIM": "embed_dim",
    "HIDDEN_DIM": "hidden_dim",
    "RNN_TYPE": "rnn_type",
    "NUM_LAYERS": "num_layers",
    "BIDIRECTIONAL": "bidirectional",
    "DROPOUT": "dropout",
    "NORMALIZE_OUTPUT": "normalize_output",
    # optimization
    "BATCH_SIZE": "batch_size",
    "EPOCHS": "epochs",
    "LR": "lr",
    "MARGIN": "margin",
    # ---- TPU-build extensions (absent in reference) ----
    "TOWER_TYPE": "tower_type",
    "LOSS_TYPE": "loss_type",
    "TEMPERATURE": "temperature",
    "TRIPLET_METRICS": "triplet_metrics",
    "MAX_QUERY_LEN": "max_query_len",
    "MAX_DOC_LEN": "max_doc_len",
    "LENGTH_BUCKETS": "length_buckets",
    "FREEZE_EMBEDDINGS": "freeze_embeddings",
    "COMPUTE_DTYPE": "compute_dtype",
    "PARAM_DTYPE": "param_dtype",
    "GRAD_CLIP_NORM": "grad_clip_norm",
    "SEED": "seed",
    "MESH_DATA": "mesh_data",
    "MESH_MODEL": "mesh_model",
    "SHARD_EMBEDDING_TABLE": "shard_embedding_table",
    "CROSS_DEVICE_NEGATIVES": "cross_device_negatives",
    "NUM_HEADS": "num_heads",
    "FFN_DIM": "ffn_dim",
    "REMAT_BLOCKS": "remat_blocks",
    "RESIDUAL_DTYPE": "residual_dtype",
    "FUSED_ATTENTION": "fused_attention",
    "CHECKPOINT_EVERY_STEPS": "checkpoint_every_steps",
    "LOG_EVERY_STEPS": "log_every_steps",
    "STEPS_PER_DISPATCH": "steps_per_dispatch",
    "LOG_PARAM_STATS": "log_param_stats",
    "LOG_PARAM_HISTOGRAMS": "log_param_histograms",
}
_FIELD_TO_KEY = {v: k for k, v in _KEY_TO_FIELD.items()}


@dataclasses.dataclass
class Config:
    """Full framework configuration.

    Defaults mirror backend/config.json:9-24 of the reference where a
    counterpart exists; TPU-only fields default to sensible single-chip
    values.
    """

    # --- data (ref: backend/config.json:2-10) ---
    train_dataset_path: str = "data/ms_marco_train.parquet"
    val_dataset_path: str = "data/ms_marco_validation.parquet"
    test_dataset_path: str = "data/ms_marco_test.parquet"
    embeddings_path: str = "data/embeddings.npy"
    word_to_idx_path: str = "data/word_to_idx.pkl"
    subsample_ratio: Optional[float] = 0.005
    num_triplets_per_query: int = 1
    training_mode: str = "retrieval"  # 'retrieval' | 'ranking'

    # --- model (ref: backend/config.json:12-16, model.py:84-94) ---
    vocab_size: Optional[int] = None  # runtime-derived, persisted w/ artifacts
    embed_dim: Optional[int] = None  # runtime-derived from embeddings.npy
    hidden_dim: int = 256
    rnn_type: str = "GRU"  # 'GRU' | 'LSTM' | 'RNN'
    num_layers: int = 2
    bidirectional: bool = True
    dropout: float = 0.2
    normalize_output: bool = True

    # --- optimization (ref: backend/config.json:18-23) ---
    batch_size: int = 64
    epochs: int = 1
    lr: float = 5e-5
    margin: float = 0.5

    # --- TPU-build extensions ---
    tower_type: str = "rnn"  # 'rnn' | 'transformer'
    loss_type: str = "triplet"  # 'triplet' | 'in_batch' | 'triplet+in_batch'
    temperature: float = 0.05  # softmax temperature for in-batch loss
    # With a pure in-batch loss the explicit negative contributes NOTHING
    # to the gradient (combined_loss never reads it; XLA dead-code
    # eliminates its backward) — only the triplet metric set
    # (neg_similarity, similarity_gap, triplet_accuracy) still consumes
    # it. False skips the negative's doc-tower forward entirely (the doc
    # tower encodes [B] instead of [2B] rows) and drops those metrics;
    # ignored (negatives always encoded) when the loss itself needs them.
    triplet_metrics: bool = True
    max_query_len: int = 32  # static shapes: queries are short (MS MARCO)
    max_doc_len: int = 128  # static shapes: passages truncated here
    length_buckets: Optional[List[int]] = None  # e.g. [32, 64, 128]
    freeze_embeddings: bool = True  # ref freezes GloVe (model.py:24-27)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    grad_clip_norm: float = 1.0  # ref: backend/main.py:257
    seed: int = 0
    mesh_data: int = -1  # -1 → all devices on the data axis
    mesh_model: int = 1
    shard_embedding_table: bool = False  # row-shard GloVe across 'model' axis
    cross_device_negatives: bool = True  # all_gather docs across 'data' axis
    num_heads: int = 4  # transformer tower
    ffn_dim: int = 1024  # transformer tower
    # Rematerialize each transformer block in the backward pass
    # (jax.checkpoint): trades ~1/3 more matmul FLOPs for not storing the
    # per-block intermediates — caps activation memory at O(layers)
    # residuals, the standard way to fit bigger batches.
    remat_blocks: bool = False
    # Residual-stream dtype for the transformer tower: 'float32' (default)
    # or 'bfloat16'. bf16 halves the HBM traffic of every elementwise op
    # and saved residual; layer-norm statistics stay in f32 either way.
    residual_dtype: str = "float32"
    # Fused VMEM-resident attention kernel for the transformer tower
    # (ops/attention.py) — the long-sequence MEMORY valve, measured
    # slower than the transpose-free bf16-score XLA path at encoder
    # shapes (docs/RESULTS.md round 4). Tri-state: None = auto
    # (currently: off), True/False force the Pallas / XLA path.
    fused_attention: Optional[bool] = None
    checkpoint_every_steps: int = 500
    # Train steps executed per jitted dispatch (lax.scan over a [K, B, W]
    # packed-batch stack). On remote-attached TPUs each dispatch/transfer is
    # a round-trip; K > 1 amortizes it. 1 = one step per dispatch.
    steps_per_dispatch: int = 8
    log_every_steps: int = 50
    # Per-leaf gradient/parameter norms in the metric stream (the role of
    # the reference's wandb.watch(log_freq=50), ref: backend/main.py:234);
    # computed on-device in the same fused step program. Tri-state:
    # None = auto (on exactly when W&B logging is on, mirroring the
    # reference where watch() only runs under wandb); an explicit
    # True/False always wins — the stats cost ~20% step time on small
    # towers, so users can run --wandb without paying it
    # (LOG_PARAM_STATS: false) or log stats without W&B (true).
    log_param_stats: Optional[bool] = None
    # Per-leaf fixed-bin gradient/parameter HISTOGRAMS in the metric
    # stream (full wandb.watch parity — the reference logs histograms
    # every 50 batches, ref: backend/main.py:234). Same tri-state
    # semantics as log_param_stats. Histograms bucket every grad/param
    # element, so the training loop computes them only in dispatch groups that
    # cross a log_every_steps boundary (a second step executable; the
    # steady-state step pays nothing).
    log_param_histograms: Optional[bool] = None

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        self.rnn_type = str(self.rnn_type).upper()
        if self.rnn_type not in ("GRU", "LSTM", "RNN"):
            raise ValueError(f"RNN_TYPE must be GRU|LSTM|RNN, got {self.rnn_type}")
        if self.training_mode not in ("retrieval", "ranking"):
            raise ValueError(f"TRAINING_MODE must be retrieval|ranking, got {self.training_mode}")
        if self.tower_type not in ("rnn", "transformer"):
            raise ValueError(f"TOWER_TYPE must be rnn|transformer, got {self.tower_type}")
        if self.loss_type not in ("triplet", "in_batch", "triplet+in_batch"):
            raise ValueError(f"LOSS_TYPE invalid: {self.loss_type}")
        if self.subsample_ratio is not None and not (0 < self.subsample_ratio <= 1.0):
            raise ValueError(f"SUBSAMPLE_RATIO must be in (0, 1], got {self.subsample_ratio}")
        if self.max_query_len <= 0 or self.max_doc_len <= 0:
            raise ValueError("MAX_QUERY_LEN / MAX_DOC_LEN must be positive")
        if not (0.0 <= self.dropout < 1.0):
            # inverted-scale dropout divides by (1 - p): p == 1.0 would be
            # 0/0 NaNs on every step, so reject it at config time
            raise ValueError(f"DROPOUT must be in [0, 1), got {self.dropout}")
        if self.residual_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"RESIDUAL_DTYPE must be float32|bfloat16, got {self.residual_dtype}"
            )

    # --- JSON round-trip, reference key names -------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        kwargs: Dict[str, Any] = {}
        for key, value in d.items():
            field = _KEY_TO_FIELD.get(key)
            if field is not None:
                kwargs[field] = value
            # Unknown keys are ignored (forward/backward compat), matching
            # the reference's tolerance of extra dict entries.
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str | Path) -> "Config":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            key = _FIELD_TO_KEY[field.name]
            out[key] = value
        return out

    def to_json(self, path: str | Path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    # --- convenience ---------------------------------------------------
    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def tower_kwargs(self) -> Dict[str, Any]:
        """The architecture-defining subset (ref: model.py:84-94)."""
        return dict(
            vocab_size=self.vocab_size,
            embed_dim=self.embed_dim,
            hidden_dim=self.hidden_dim,
            rnn_type=self.rnn_type,
            num_layers=self.num_layers,
            dropout=self.dropout,
            bidirectional=self.bidirectional,
            normalize_output=self.normalize_output,
        )


def load_config(path: str | Path) -> Config:
    """Load a reference-style JSON config (ref: backend/main.py:76-79)."""
    return Config.from_json(path)
