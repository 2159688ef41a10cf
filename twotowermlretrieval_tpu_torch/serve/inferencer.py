"""Serving-side model loader + query embedder (the port of the JAX
package's ``serve/inferencer.py``): construct from an artifact directory,
call ``get_query_embedding(str) -> np.ndarray[H]``; token-less queries
embed to the zero vector."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from twotowermlretrieval_tpu_torch.encoder import TextEncoder
from twotowermlretrieval_tpu_torch.train.artifacts import load_artifacts


class QueryInferencer:
    def __init__(self, artifacts_path: str | Path, batch_size: int = 8, device="cuda"):
        loaded = load_artifacts(artifacts_path, require_index=False)
        self.config = loaded.config
        self.tokenizer = loaded.tokenizer
        self.spec = loaded.spec
        self.encoder = TextEncoder(
            loaded.params, self.spec, self.tokenizer,
            batch_size=batch_size,
            max_query_len=self.config.max_query_len,
            max_doc_len=self.config.max_doc_len,
            device=device,
        )
        self.params = self.encoder.params  # on the device

    def get_query_embedding(self, query: str) -> np.ndarray:
        return self.encoder.encode_query(query)

    def get_query_embeddings(self, queries: Sequence[str]) -> np.ndarray:
        return self.encoder.encode_queries(queries)

    def get_document_embeddings(self, documents: Sequence[str]) -> np.ndarray:
        return self.encoder.encode_documents(documents)
