"""The training <-> serving artifact contract.

The same six files, in the same formats, as the JAX package's
``train/artifacts.py``: ``model.npz`` ('/'-keyed weight paths),
``config.json`` (enriched with VOCAB_SIZE / EMBED_DIM), ``word_to_idx.pkl``,
``documents.pkl``, ``document_embeddings.npy`` and ``tfidf_artifacts.pkl``
({'vectorizer', 'matrix'}). A directory written by either package serves
through the other's loader. With ``build_ivf_index`` a seventh file,
``ivf_index.npz`` (``ops/ivf.py``, the JAX package's format), carries a
prebuilt IVF index, so serving with ``--index-type ivf`` starts without
k-means; :func:`load_artifacts` loads it when it is there.

The TF-IDF pickle names its vectorizer's class by module path. The loader
here maps the JAX package's path to this package's copy of the class (the
two are the same code), so reading a JAX-written directory never imports
the JAX package.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.encoder import TextEncoder
from twotowermlretrieval_tpu_torch.ops.ivf import IVF_INDEX_FILE, build_ivf, load_ivf, save_ivf
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
from twotowermlretrieval_tpu_torch.ops.tfidf import TfidfVectorizer
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz, save_params_npz

MODEL_FILE = "model.npz"

Triplet = Tuple[str, str, str]

_TFIDF_MODULES = {
    "twotowermlretrieval_tpu.ops.tfidf": "twotowermlretrieval_tpu_torch.ops.tfidf",
}


class _ArtifactUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        return super().find_class(_TFIDF_MODULES.get(module, module), name)


def collect_unique_documents(datasets: Dict[str, Sequence[Triplet]]) -> List[str]:
    """Dedup positives + negatives across all splits, in insertion order."""
    docs: Dict[str, None] = {}
    for split_data in datasets.values():
        for _, pos_doc, neg_doc in split_data:
            docs.setdefault(pos_doc)
            docs.setdefault(neg_doc)
    return list(docs.keys())


def save_inference_artifacts(
    output_dir: str | Path,
    params,
    config: Config,
    tokenizer: Tokenizer,
    datasets: Dict[str, Sequence[Triplet]],
    encoder: TextEncoder | None = None,
    tfidf_max_features: int = 20000,
    device="cuda",
    build_ivf_index: bool = False,
    ivf_storage_dtype: str = "bfloat16",
    ivf_num_clusters: int = 0,
) -> Path:
    """Export the six-file serving contract. ``params`` is the port's tree
    of tensors (or numpy arrays); the documents are encoded by ``encoder``,
    or by a doc-tower :class:`TextEncoder` on ``device``. With
    ``build_ivf_index``, also the IVF index of the embeddings, clustered on
    ``device`` (``ivf_index.npz``)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    save_params_npz(output_dir / MODEL_FILE, params)

    # train-time placement knobs are neutralized: the artifact config is
    # the serving-side architecture contract
    enriched = config.replace(
        vocab_size=tokenizer.vocab_size(),
        embed_dim=config.embed_dim,
        shard_embedding_table=False,
        mesh_model=1,
    )
    enriched.to_json(output_dir / "config.json")

    tokenizer.save(output_dir / "word_to_idx.pkl")

    unique_docs = collect_unique_documents(datasets)
    if encoder is None:
        encoder = TextEncoder(
            params, TwoTowerSpec.from_config(enriched), tokenizer,
            batch_size=config.batch_size,
            max_query_len=config.max_query_len,
            max_doc_len=config.max_doc_len,
            device=device,
        )
    doc_embeddings = encoder.encode_documents(unique_docs)
    with open(output_dir / "documents.pkl", "wb") as f:
        pickle.dump(unique_docs, f)
    np.save(output_dir / "document_embeddings.npy", doc_embeddings)

    vectorizer = TfidfVectorizer(max_features=tfidf_max_features)
    matrix = vectorizer.fit_transform(unique_docs)
    with open(output_dir / "tfidf_artifacts.pkl", "wb") as f:
        pickle.dump({"vectorizer": vectorizer, "matrix": matrix}, f)

    if build_ivf_index:  # offline build, online load
        index = build_ivf(np.asarray(doc_embeddings, np.float32), num_clusters=ivf_num_clusters,
                          storage_dtype=ivf_storage_dtype, device=device)
        save_ivf(output_dir / IVF_INDEX_FILE, index)
    return output_dir


class LoadedArtifacts(NamedTuple):
    config: Config
    tokenizer: Tokenizer
    params: dict  # the port's tree of f32 CPU tensors
    spec: TwoTowerSpec
    documents: List[str]
    doc_embeddings: np.ndarray
    tfidf_vectorizer: TfidfVectorizer
    tfidf_matrix: object  # scipy CSR
    ivf_index: object = None  # the prebuilt ops.ivf.IVFIndex (CPU tensors), if exported


def load_artifacts(artifacts_path: str | Path, require_index: bool = True) -> LoadedArtifacts:
    """Rehydrate an artifact directory. With ``require_index=False`` only
    the model side (config, tokenizer, params) is loaded. A prebuilt IVF
    index loads onto the CPU; the serving index moves it to its device."""
    artifacts_path = Path(artifacts_path)
    if not artifacts_path.exists():
        raise FileNotFoundError(f"artifacts directory not found: {artifacts_path}")

    config = Config.from_json(artifacts_path / "config.json")
    tokenizer = Tokenizer.from_pickle(artifacts_path / "word_to_idx.pkl")
    config = config.replace(vocab_size=tokenizer.vocab_size())
    if config.embed_dim is None:
        config = config.replace(embed_dim=200)  # the reference's fallback
    params = params_from_jax(load_params_npz(artifacts_path / MODEL_FILE))
    spec = TwoTowerSpec.from_config(config)

    documents: List[str] = []
    doc_embeddings = np.zeros((0, config.hidden_dim), np.float32)
    vectorizer, matrix, ivf_index = None, None, None
    if require_index:
        with open(artifacts_path / "documents.pkl", "rb") as f:
            documents = pickle.load(f)
        doc_embeddings = np.load(artifacts_path / "document_embeddings.npy")
        with open(artifacts_path / "tfidf_artifacts.pkl", "rb") as f:
            tfidf = _ArtifactUnpickler(f).load()
        vectorizer, matrix = tfidf["vectorizer"], tfidf["matrix"]
        if (artifacts_path / IVF_INDEX_FILE).exists():
            ivf_index = load_ivf(artifacts_path / IVF_INDEX_FILE)

    return LoadedArtifacts(
        config=config,
        tokenizer=tokenizer,
        params=params,
        spec=spec,
        documents=documents,
        doc_embeddings=doc_embeddings,
        tfidf_vectorizer=vectorizer,
        tfidf_matrix=matrix,
        ivf_index=ivf_index,
    )
