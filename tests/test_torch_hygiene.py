"""Port hygiene: no JAX in the port, no quiet CPU fallback, and its copies
of the JAX package's host modules behave identically."""

import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.ops.tfidf import TfidfVectorizer as JaxTfidfVectorizer
from twotowermlretrieval_tpu.tokenizer import Tokenizer as JaxTokenizer
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.ops.tfidf import TfidfVectorizer
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_CHECK = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import twotowermlretrieval_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    if len(sys.argv) > 1:  # also load an artifact directory the JAX package wrote
        from twotowermlretrieval_tpu_torch.train.artifacts import load_artifacts
        loaded = load_artifacts(sys.argv[1])
        assert type(loaded.tfidf_vectorizer).__module__ == "twotowermlretrieval_tpu_torch.ops.tfidf"
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                 or m.startswith("jaxlib.") or m == "twotowermlretrieval_tpu"
                 or m.startswith("twotowermlretrieval_tpu."))
    print(json.dumps({"modules": names, "bad": bad}))
""")


def _run_import_check(*args):
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK, *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port imports, and afterwards neither jax nor any
    module of the JAX package is loaded. The prefix test must not mistake
    twotowermlretrieval_tpu_torch for the JAX package."""
    res = _run_import_check()
    assert len(res["modules"]) >= 20
    for name in ("mesh", "collectives", "distributed", "topk", "ivf"):
        assert f"twotowermlretrieval_tpu_torch.parallel.{name}" in res["modules"]
    assert res["bad"] == []
    assert "twotowermlretrieval_tpu_torch".startswith("twotowermlretrieval_tpu")


def test_jax_written_artifacts_load_without_the_jax_package(tmp_path):
    """The TF-IDF pickle of a JAX-written directory names the JAX class;
    the port's loader maps it to its own copy instead of importing it."""
    from twotowermlretrieval_tpu.utils.pytree import save_params_npz as jax_save

    cfg = JaxConfig(vocab_size=5, embed_dim=4, hidden_dim=4, num_layers=1,
                    bidirectional=False)
    cfg.to_json(tmp_path / "config.json")
    JaxTokenizer({"a": 0, "b": 1, "c": 2, "d": 3}).save(tmp_path / "word_to_idx.pkl")
    rng = np.random.default_rng(0)
    enc = {"embedding": rng.normal(size=(5, 4)).astype(np.float32),
           "layers": ({"fwd": {"w_ih": np.zeros((4, 12), np.float32),
                               "w_hh": np.zeros((4, 12), np.float32),
                               "b_ih": np.zeros(12, np.float32),
                               "b_hh": np.zeros(12, np.float32)}},)}
    jax_save(tmp_path / "model.npz", {"query": enc, "doc": enc})
    docs = ["alpha beta", "beta gamma"]
    with open(tmp_path / "documents.pkl", "wb") as f:
        pickle.dump(docs, f)
    np.save(tmp_path / "document_embeddings.npy", np.eye(2, 4, dtype=np.float32))
    vec = JaxTfidfVectorizer()
    with open(tmp_path / "tfidf_artifacts.pkl", "wb") as f:
        pickle.dump({"vectorizer": vec, "matrix": vec.fit_transform(docs)}, f)
    assert _run_import_check(str(tmp_path))["bad"] == []


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalIndex(np.zeros((4, 8), np.float32))  # default device is cuda
    assert resolve_device("cpu").type == "cpu"


def test_unported_options_point_at_roadmap():
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    rng = np.random.default_rng(0)
    docs = rng.standard_normal((300, 8)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    # a mesh is ported: two shards on the CPU search as one device does
    sharded = RetrievalIndex(docs, device="cpu", mesh=make_device_mesh(2, 1, ["cpu", "cpu"]))
    one = RetrievalIndex(docs, device="cpu")
    assert len(sharded._docs) == 2 and sharded.autotune() == {}
    for got, want in zip(sharded.search(docs[:5], 10), one.search(docs[:5], 10)):
        np.testing.assert_array_equal(got, want)
    # the IVF index is ported: it builds, and searches its own rows
    index = RetrievalIndex(docs, device="cpu", index_type="ivf", num_clusters=8, nprobe=8)
    assert index.ivf is not None and not index.kernel_on()
    assert index.tuning_signature()["index_type"] == "ivf"
    _, ids = index.search(docs[:5], k=3)
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="index_type"):
        RetrievalIndex(docs, device="cpu", index_type="hnsw")


def test_tfidf_copy_is_bit_identical():
    docs = [
        "The quick brown fox jumps over the lazy dog.",
        "Lazy dogs sleep; quick foxes run!",
        "Retrieval with two towers and TF-IDF blending, 2024 edition.",
        "", "fox fox fox dog", "Ünïcode wörds and numbers 42 42",
    ]
    for max_features in (None, 5):
        a, b = TfidfVectorizer(max_features), JaxTfidfVectorizer(max_features)
        ma, mb = a.fit_transform(docs), b.fit_transform(docs)
        assert a.vocabulary_ == b.vocabulary_
        np.testing.assert_array_equal(a.idf_, b.idf_)
        for x, y in ((ma, mb), (a.transform(["quick fox"]), b.transform(["quick fox"]))):
            np.testing.assert_array_equal(x.indptr, y.indptr)
            np.testing.assert_array_equal(x.indices, y.indices)
            np.testing.assert_array_equal(x.data, y.data)


def test_tokenizer_and_config_copies_match():
    vocab = {"hello": 0, "world": 1, ",": 2, "!": 3}
    texts = ["Hello, world!", "", "unknown words here", "hello " * 40]
    a, b = Tokenizer(vocab), JaxTokenizer(vocab)
    ta, la = a.encode_batch(texts, 16)
    tb, lb = b.encode_batch(texts, 16, native=False)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(la, lb)
    assert a.unk_token_id == b.unk_token_id
    cfg = JaxConfig(vocab_size=10, embed_dim=4, rnn_type="lstm", length_buckets=[8, 16])
    assert Config.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    assert Config().to_dict() == JaxConfig().to_dict()


def test_kernel_build_is_keyed_on_source_content(tmp_path, monkeypatch):
    """The build cache key covers the source text: an edit names a new
    library, an unchanged source the same one."""
    from twotowermlretrieval_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setenv("TTR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build._target("k")
    assert first == _build._target("k") and first.parent == tmp_path / "build"
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build._target("k") != first


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """Without the CUDA toolkit the build fails loudly; nothing is built
    when the port's modules are imported (the import test above)."""
    from twotowermlretrieval_tpu_torch.ops import _build

    monkeypatch.setenv("TTR_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not list(tmp_path.glob("*.so"))
