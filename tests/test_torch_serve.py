"""The port's serving slice against the JAX package's, end to end.

One artifact directory is exported by the JAX package (JAX towers + JAX
``save_inference_artifacts`` on the synthetic corpus); the JAX
``SearchEngine`` and the port's ``SearchEngine`` (on the CPU, so with the
plain versions of the kernels) answer the same queries. A second directory
is exported by the port and served by the JAX loader. Then the port's HTTP
server answers with the JAX server's keys.

Tolerances: f32 compute and storage, scores within 1e-5 (the same
arithmetic, sums in another order) and the same documents in the same
order up to ties; bf16, scores within 2e-2 (the JAX CPU scan keeps the
input projection in f32, the port rounds it to bf16 as the TPU kernel
does), order compared only where scores differ by more than that. A
third directory holds a JAX transformer two-tower (f32, its default
attention route): scores within 1e-5.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.data.loader import TripletBuilder
from twotowermlretrieval_tpu.data.synthetic import synthetic_config
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.serve.app import make_handler as jax_make_handler
from twotowermlretrieval_tpu.serve.engine import SearchEngine as JaxSearchEngine
from twotowermlretrieval_tpu.tokenizer import Tokenizer as JaxTokenizer
from twotowermlretrieval_tpu.train.artifacts import load_artifacts as jax_load_artifacts
from twotowermlretrieval_tpu.train.artifacts import (
    save_inference_artifacts as jax_save_inference_artifacts,
)
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
from twotowermlretrieval_tpu_torch.serve.app import serve
from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
from twotowermlretrieval_tpu_torch.train.artifacts import (
    load_artifacts,
    save_inference_artifacts,
)

QUERIES = ["t0w1 t0w2", "t3w4 t5w6 t5w7", "t11w19", "nothing known here", "t7w2 t7w3 t2w1"]
ALPHAS = [0.0, 0.5, 1.0]


def _config(synth_dir, compute_dtype, **tower):
    cfg = synthetic_config(
        synth_dir, hidden_dim=32, num_layers=2, bidirectional=True,
        compute_dtype=compute_dtype, **tower,
    )
    tok = JaxTokenizer.from_pickle(cfg.word_to_idx_path)
    return cfg.replace(vocab_size=tok.vocab_size(), embed_dim=16), tok


@pytest.fixture(scope="module")
def datasets(synth_dir):
    cfg, _ = _config(synth_dir, "float32")
    return TripletBuilder(cfg).load_datasets()


def _export_jax(synth_dir, datasets, out, compute_dtype, **tower):
    cfg, tok = _config(synth_dir, compute_dtype, **tower)
    params = jax_init_two_tower(jax.random.key(0), JaxTwoTowerSpec.from_config(cfg))
    jax_save_inference_artifacts(out, params, cfg, tok, datasets)
    return out


@pytest.fixture(scope="module")
def jax_artifacts_float32(synth_dir, datasets, tmp_path_factory):
    return _export_jax(synth_dir, datasets, tmp_path_factory.mktemp("jax_f32"), "float32")


@pytest.fixture(scope="module")
def jax_artifacts_bfloat16(synth_dir, datasets, tmp_path_factory):
    return _export_jax(synth_dir, datasets, tmp_path_factory.mktemp("jax_bf16"), "bfloat16")


@pytest.fixture(scope="module")
def jax_artifacts_transformer(synth_dir, datasets, tmp_path_factory):
    """A JAX transformer two-tower (2 blocks, 4 heads of width 8), f32."""
    return _export_jax(synth_dir, datasets, tmp_path_factory.mktemp("jax_tf"), "float32",
                       tower_type="transformer", num_heads=4, ffn_dim=64)


def _assert_same_results(p_res, j_res, tol):
    """Same documents in the same order up to ties within ``tol``."""
    ps = np.array([r["score"] for r in p_res])
    js = np.array([r["score"] for r in j_res])
    assert len(ps) == len(js)
    if not len(ps):
        return
    np.testing.assert_allclose(ps, js, rtol=0, atol=tol)
    for mine, other, other_scores in ((p_res, j_res, js), (j_res, p_res, ps)):
        by_doc = {r["doc"]: r for r in other}
        for r in mine:
            twin = by_doc.get(r["doc"])
            if twin is None:  # cut off at the boundary by a near-tie
                assert r["score"] <= other_scores[-1] + tol
                continue
            for key in ("score", "dense_score", "tfidf_score"):
                assert abs(r[key] - twin[key]) <= tol, (key, r, twin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "transformer"])
def test_search_matches_jax_engine(request, dtype):
    path = request.getfixturevalue(f"jax_artifacts_{dtype}")
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    storage = "float32" if dtype == "transformer" else dtype
    port = SearchEngine(path, device="cpu", storage_dtype=storage)
    ref = JaxSearchEngine(path, storage_dtype=storage)
    assert port.inferencer.spec.tower_type == ("transformer" if dtype == "transformer" else "rnn")
    assert port.index.num_docs == ref.index.num_docs
    for q in QUERIES:
        for alpha in ALPHAS:
            p, j = port.search(q, alpha=alpha), ref.search(q, alpha=alpha)
            assert p["query"] == j["query"] and p["alpha"] == j["alpha"]
            assert [r["rank"] for r in p["results"]] == [r["rank"] for r in j["results"]]
            _assert_same_results(p["results"], j["results"], tol)
            if alpha == 0.0:  # the keyword branch is bit-identical
                assert p["results"] == j["results"]


def test_port_artifacts_serve_through_jax_loader(synth_dir, datasets, tmp_path):
    cfg, _ = _config(synth_dir, "float32")
    port_cfg = Config.from_dict(cfg.to_dict())
    tok = Tokenizer.from_pickle(cfg.word_to_idx_path)
    params = init_two_tower(torch.Generator().manual_seed(0), TwoTowerSpec.from_config(port_cfg))
    save_inference_artifacts(tmp_path, params, port_cfg, tok, datasets, device="cpu")

    loaded = jax_load_artifacts(tmp_path)
    mine = load_artifacts(tmp_path)
    np.testing.assert_array_equal(loaded.doc_embeddings, mine.doc_embeddings)
    assert loaded.documents == mine.documents
    assert loaded.config.to_dict() == mine.config.to_dict()
    # the JAX doc tower re-encodes the port's documents to the port's embeddings
    from twotowermlretrieval_tpu.encoder import TextEncoder as JaxTextEncoder

    enc = JaxTextEncoder(loaded.params, loaded.spec, loaded.tokenizer,
                         max_doc_len=loaded.config.max_doc_len)
    np.testing.assert_allclose(
        enc.encode_documents(loaded.documents[:40]), mine.doc_embeddings[:40], rtol=0, atol=1e-5
    )
    port = SearchEngine(tmp_path, device="cpu", storage_dtype="float32")
    ref = JaxSearchEngine(tmp_path, storage_dtype="float32")
    for q in QUERIES[:3]:
        _assert_same_results(
            port.search(q, alpha=0.5)["results"], ref.search(q, alpha=0.5)["results"], 1e-5
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_search_matches_jax_index(dtype):
    """RetrievalIndex.search on host queries (5 rows, padded to 8 inside)
    returns the JAX index's ids and scores (f32 sums in another order)."""
    from twotowermlretrieval_tpu.serve.index import RetrievalIndex as JaxRetrievalIndex
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    rng = np.random.default_rng(21)
    docs = rng.normal(size=(3000, 32)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    vals, ids = RetrievalIndex(docs, storage_dtype=dtype, device="cpu").search(q, 20)
    j_vals, j_ids = JaxRetrievalIndex(docs, storage_dtype=dtype, interpret=True).search(q, 20)
    assert vals.shape == ids.shape == (5, 20)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(vals, j_vals, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_int8_index_equals_jax_index_bitwise(use_kernel):
    """The int8 index (rows padded to 8192, then one scale per 128-row
    segment) returns the JAX index's ids and values to the bit, on the
    fused path (JAX's s8 kernel in interpret mode) and the two-phase path
    alike. On the CPU use_kernel=None takes the two-phase path, as JAX's
    use_pallas=None does off the TPU."""
    from twotowermlretrieval_tpu.serve.index import RetrievalIndex as JaxRetrievalIndex
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    rng = np.random.default_rng(22)
    docs = rng.normal(size=(3000, 32)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    port = RetrievalIndex(docs, storage_dtype="int8", device="cpu", use_kernel=use_kernel)
    assert port.kernel_on() is bool(use_kernel)
    ref = JaxRetrievalIndex(docs, storage_dtype="int8", use_pallas=use_kernel, interpret=True)
    np.testing.assert_array_equal(port._docs.numpy(), np.asarray(ref._docs))
    np.testing.assert_array_equal(port._scales.numpy(), np.asarray(ref._scales))
    for phase2, srt in RetrievalIndex._AUTOTUNE_VARIANTS[:4]:
        port.phase2, port.sort_candidates = ref.phase2, ref.sort_candidates = phase2, srt
        vals, ids = port.search(q, 20)
        j_vals, j_ids = ref.search(q, 20)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(vals, j_vals)


# int8 engine against the JAX int8 engine: the f32 towers agree within
# 1e-5, which can flip the int8 rounding of a query element lying on a
# rounding boundary; one flip moves a score by one quantization step,
# q_scale * |d_i| <= (0.5 / 127) * 0.6 < 2.5e-3 for these unit rows. The
# tolerance allows two.
INT8_ENGINE_TOL = 5e-3


def test_int8_engine_matches_jax_engine(jax_artifacts_float32):
    port = SearchEngine(jax_artifacts_float32, device="cpu", storage_dtype="int8")
    ref = JaxSearchEngine(jax_artifacts_float32, storage_dtype="int8")
    for q in QUERIES:
        for alpha in ALPHAS:
            p, j = port.search(q, alpha=alpha), ref.search(q, alpha=alpha)
            _assert_same_results(p["results"], j["results"], INT8_ENGINE_TOL)
            if alpha == 0.0:
                assert p["results"] == j["results"]
    fused = SearchEngine(jax_artifacts_float32, device="cpu", storage_dtype="int8",
                         use_kernel=True)
    requests = [{"query": q, "fanout": 50} for q in QUERIES]
    for (a_s, a_i), (b_s, b_i) in zip(port._dense_batch(requests), fused._dense_batch(requests)):
        np.testing.assert_array_equal(a_i, b_i)  # two-phase and fused: the same bits
        np.testing.assert_array_equal(a_s, b_s)


# ---------------------------------------------------------------------------
# autotune and the persisted decision (retrieval_tuning.json)
# ---------------------------------------------------------------------------


def _unit_docs(seed, n, h):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, h)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True), rng


def test_autotune_selects_fastest_variant_and_search_agrees():
    """autotune keeps the variant the (injected) timer says is fastest, and
    search under that variant returns the default's results bit for bit
    (s8 scores are exact integers); the two-phase path winning routes
    search off the fused path."""
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    d, rng = _unit_docs(23, 700, 16)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    index = RetrievalIndex(d, storage_dtype="int8", device="cpu", use_kernel=True)
    base_vals, base_ids = index.search(q, k=20)
    canned = {
        ("rescore", False): 3e-3, ("rescore", True): 2e-3,
        ("gather", False): 4e-3, ("gather", True): 1e-3,
        ("two_phase", False): 5e-3,
    }
    timings = index.autotune(timer=lambda p, s, B, k, iters: canned[(p, s)])
    assert timings == canned
    assert (index.phase2, index.sort_candidates) == ("gather", True)
    vals, ids = index.search(q, k=20)
    np.testing.assert_array_equal(ids, base_ids)
    np.testing.assert_array_equal(vals, base_vals)

    canned[("two_phase", False)] = 1e-4
    index.autotune(timer=lambda p, s, B, k, iters: canned[(p, s)])
    assert index.use_kernel is False and not index.kernel_on()
    assert index.decision() == {"phase2": "rescore", "sort_candidates": False,
                                "use_pallas": False}
    vals, ids = index.search(q, k=20)
    np.testing.assert_array_equal(ids, base_ids)
    np.testing.assert_array_equal(vals, base_vals)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_autotune_on_a_card_index_keeps_the_kernel(dtype):
    """A CUDA index times the four fused variants only, and a persisted
    decision that turns the fused path off is not applied to it: no timing
    takes a card's searches off the kernel. (The index is built on the CPU
    and relabelled; only the decision logic runs, no search.)"""
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    d, _ = _unit_docs(26, 300, 16)
    index = RetrievalIndex(d, storage_dtype=dtype, device="cpu")
    index.device = torch.device("cuda")
    assert index.kernel_on()
    canned = {
        ("rescore", False): 3e-3, ("rescore", True): 2e-3,
        ("gather", False): 4e-3, ("gather", True): 1e-3,
        ("two_phase", False): 1e-4,
    }
    timings = index.autotune(timer=lambda p, s, B, k, iters: canned[(p, s)])
    assert set(timings) == set(RetrievalIndex._AUTOTUNE_VARIANTS[:4])
    assert index.decision() == {"phase2": "gather", "sort_candidates": True,
                                "use_pallas": None}
    index.apply_decision({"phase2": "rescore", "sort_candidates": False, "use_pallas": False})
    assert index.use_kernel is None and index.kernel_on()
    assert (index.phase2, index.sort_candidates) == ("rescore", False)
    index.apply_decision({"phase2": "gather", "sort_candidates": False, "use_pallas": True})
    assert index.use_kernel is True


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_autotune_real_timer_runs_all_variants(dtype):
    """The measurement path itself times every variant and picks one (tiny
    sizes, host clock on the CPU); search still answers under the winner."""
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    d, rng = _unit_docs(24, 600, 8)
    index = RetrievalIndex(d, storage_dtype=dtype, device="cpu", use_kernel=True)
    timings = index.autotune(B=2, k=5, iters=3)
    assert set(timings) == set(RetrievalIndex._AUTOTUNE_VARIANTS)
    assert all(t > 0 for t in timings.values())
    assert (index.phase2, index.sort_candidates) in timings or index.use_kernel is False
    vals, ids = index.search(rng.normal(size=(2, 8)).astype(np.float32), k=5)
    assert vals.shape == ids.shape == (2, 5)


def test_autotune_noop_off_the_fused_path():
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    d, _ = _unit_docs(25, 100, 8)
    for use_kernel in (False, None):  # None on a CPU index: the two-phase path
        index = RetrievalIndex(d, storage_dtype="int8", device="cpu", use_kernel=use_kernel)
        assert index.autotune() == {}
        assert (index.phase2, index.sort_candidates) == ("rescore", False)


def test_autotune_decision_persisted_and_applied(jax_artifacts_float32, tmp_path, monkeypatch):
    """autotune_retrieval writes its winner into the artifact directory;
    the next boot applies it and runs no timing."""
    import shutil

    from twotowermlretrieval_tpu_torch.serve import index as index_mod

    art = tmp_path / "art_tuned"
    shutil.copytree(jax_artifacts_float32, art)
    eng = SearchEngine(art, device="cpu", storage_dtype="int8", use_kernel=True,
                       autotune_retrieval=True)
    rec = json.loads((art / index_mod.RETRIEVAL_TUNING_FILE).read_text())
    assert rec["decision_signature"] == eng.index.tuning_signature()
    assert rec["decision"] == eng.index.decision()
    assert set(rec["timings_ms"]) == {"rescore", "rescore+sorted", "gather", "gather+sorted",
                                      "two_phase"}

    def boom(*a, **k):
        raise AssertionError("a restart ran a timing")

    monkeypatch.setattr(index_mod.RetrievalIndex, "_time_variant", boom)
    eng2 = SearchEngine(art, device="cpu", storage_dtype="int8")
    assert eng2.index.decision() == rec["decision"]
    assert len(eng2.search("t0w1 t0w2", alpha=0.7, top_k=5)["results"]) == 5
    # an explicit use_kernel wins over the record, as an explicit use_pallas does in JAX
    eng3 = SearchEngine(art, device="cpu", storage_dtype="int8", use_kernel=False)
    assert eng3.index.decision() == {"phase2": "rescore", "sort_candidates": False,
                                     "use_pallas": False}


def test_stale_tuning_record_is_ignored(jax_artifacts_float32, tmp_path):
    """A record measured for another corpus shape or backend is not
    applied, and neither is a decision of the JAX package's TPU runs."""
    import shutil

    from twotowermlretrieval_tpu_torch.serve import index as index_mod

    art = tmp_path / "art_stale"
    shutil.copytree(jax_artifacts_float32, art)
    n = np.load(art / "document_embeddings.npy").shape
    for sig in ({"num_docs": 999999, "dim": 4}, {"num_docs": n[0], "dim": n[1]}):
        index_mod.save_retrieval_tuning(art, {
            "decision_signature": {**sig, "storage_dtype": "int8", "index_type": "exact",
                                   "backend": "tpu"},
            "decision": {"phase2": "gather", "sort_candidates": True, "use_pallas": True},
        })
        eng = SearchEngine(art, device="cpu", storage_dtype="int8")
        assert eng.index.decision() == {"phase2": "rescore", "sort_candidates": False,
                                        "use_pallas": None}


def test_inferencer_matches_jax_inferencer(jax_artifacts_float32):
    """QueryInferencer on the CPU embeds like the JAX one (f32, atol 1e-5);
    a token-less query embeds to the zero vector."""
    from twotowermlretrieval_tpu.serve.inferencer import QueryInferencer as JaxQueryInferencer
    from twotowermlretrieval_tpu_torch.serve.inferencer import QueryInferencer

    port = QueryInferencer(jax_artifacts_float32, device="cpu")
    ref = JaxQueryInferencer(jax_artifacts_float32)
    np.testing.assert_allclose(port.get_query_embeddings(QUERIES),
                               ref.get_query_embeddings(QUERIES), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.get_query_embedding(QUERIES[0]),
                               ref.get_query_embedding(QUERIES[0]), rtol=0, atol=1e-5)
    docs = ["t0w1 t0w2 t0w3 t1w1", "t4w4 t4w5"]
    np.testing.assert_allclose(port.get_document_embeddings(docs),
                               ref.get_document_embeddings(docs), rtol=0, atol=1e-5)
    assert (port.get_query_embedding("") == 0).all()


# ---------------------------------------------------------------------------
# HTTP contract: the port's server against the JAX server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(jax_artifacts_float32):
    from http.server import ThreadingHTTPServer

    path = jax_artifacts_float32
    port_server = serve(str(path), port=0, host="127.0.0.1", device="cpu",
                        storage_dtype="float32")
    jax_server = ThreadingHTTPServer(
        ("127.0.0.1", 0), jax_make_handler(JaxSearchEngine(path, storage_dtype="float32"), None)
    )
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in (port_server, jax_server)]
    for t in threads:
        t.start()
    yield tuple(f"http://127.0.0.1:{s.server_address[1]}" for s in (port_server, jax_server))
    for s in (port_server, jax_server):
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=10)


def _post(url, payload):
    req = urllib.request.Request(
        url + "/search", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, resp.read().decode()


@pytest.mark.parametrize("payload", [
    {"query": "t0w1 t0w2", "alpha": 0.7},
    {"query": "t0w1"},
    {"query": "t2w3 t2w4", "alpha": 0.0},
    {"alpha": 0.5},
    {"query": "x", "alpha": "not-a-float"},
])
def test_http_search_contract_matches_jax(servers, payload):
    port_url, jax_url = servers
    p_status, p_body, p_headers = _post(port_url, payload)
    j_status, j_body, _ = _post(jax_url, payload)
    assert p_status == j_status
    assert p_headers.get("Access-Control-Allow-Origin") == "*"
    assert set(p_body) == set(j_body)
    if p_status == 200:
        assert (p_body["query"], p_body["alpha"]) == (j_body["query"], j_body["alpha"])
        assert [set(r) for r in p_body["results"]] == [set(r) for r in j_body["results"]]
        assert all(r["rank"] == i + 1 for i, r in enumerate(p_body["results"]))
        _assert_same_results(p_body["results"], j_body["results"], 1e-5)


def test_http_health_and_metrics_match_jax(servers):
    port_url, jax_url = servers
    _post(port_url, {"query": "t0w1 metrics-probe", "alpha": 0.5})
    (ps, ph), (js, jh) = _get(port_url, "/health"), _get(jax_url, "/health")
    assert ps == js == 200 and json.loads(ph) == json.loads(jh)
    status, body = _get(port_url, "/metrics")
    assert status == 200
    for name in ('ttr_http_requests_total{path="/search",code="200"}',
                 'ttr_http_request_seconds_bucket{le="+Inf"}',
                 "ttr_http_request_seconds_count", "ttr_searches_total",
                 "ttr_cache_hits_total", "ttr_index_num_docs"):
        assert name in body
    metric_names = {line.split("{")[0].split(" ")[0] for line in body.splitlines()
                    if line and not line.startswith("#")}
    jax_names = {line.split("{")[0].split(" ")[0] for line in _get(jax_url, "/metrics")[1].splitlines()
                 if line and not line.startswith("#")}
    assert metric_names == jax_names


# ---------------------------------------------------------------------------
# SimpleHybridRetriever: the library path against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("doc_tower", [True, False], ids=["doc-tower", "query-tower"])
def test_simple_hybrid_matches_jax(jax_artifacts_float32, datasets, doc_tower):
    """Fit on the same documents (f32 index, k = N dense search), the same
    documents in the same order and blended scores within 1e-5 (the f32
    towers' sums in another order), up to ties within that."""
    from twotowermlretrieval_tpu.serve.simple_hybrid import (
        SimpleHybridRetriever as JaxSimpleHybridRetriever,
    )
    from twotowermlretrieval_tpu_torch.serve.simple_hybrid import SimpleHybridRetriever

    docs = list(dict.fromkeys(p for trip in datasets["train"] for p in trip[1:]))[:150]
    port = SimpleHybridRetriever(jax_artifacts_float32, doc_tower=doc_tower, device="cpu")
    ref = JaxSimpleHybridRetriever(jax_artifacts_float32, doc_tower=doc_tower,
                                   use_pallas=False)
    port.fit(docs)
    ref.fit(docs)
    assert port.index.num_docs == len(docs) and port.index.storage_dtype == "float32"
    for q in QUERIES:
        got, want = port.search(q, top_k=10), ref.search(q, top_k=10)
        assert len(got) == len(want) == 10
        gs, ws = np.array([s for _, s in got]), np.array([s for _, s in want])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        for i, ((doc, _), (twin, _)) in enumerate(zip(got, want)):
            if doc != twin:  # only a near-tie may swap places
                assert abs(gs[i] - ws[i]) <= 1e-5 and any(
                    abs(ws[j] - ws[i]) <= 2e-5 for j in range(10) if j != i), (q, i)


def test_simple_hybrid_search_before_fit_raises(jax_artifacts_float32):
    from twotowermlretrieval_tpu_torch.serve.simple_hybrid import SimpleHybridRetriever

    with pytest.raises(RuntimeError, match="fit"):
        SimpleHybridRetriever(jax_artifacts_float32, device="cpu").search("t0w1")
