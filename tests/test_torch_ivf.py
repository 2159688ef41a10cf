"""The port's IVF index (``twotowermlretrieval_tpu_torch/ops/ivf.py``)
against the JAX package's ``ops/ivf.py`` on small clustered corpora made
from a numpy seed, both on the CPU.

Tolerances: the ids of a search over the same index file are equal; its
scores agree within 1e-5 relative (f32 sums of the same exact products, in
another order). One Lloyd step from the same centroids agrees within 1e-5
relative (``index_add_`` against ``segment_sum``: another summation order),
and the assignment of a chunk is identical.
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops import ivf as jivf
from twotowermlretrieval_tpu_torch.ops import ivf as tivf
from twotowermlretrieval_tpu_torch.ops.topk import topk_oracle

N, H, CENTERS = 2048, 32, 24


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    centers = _unit(rng.standard_normal((CENTERS, H)))
    docs = _unit(centers[rng.integers(0, CENTERS, N)] + 0.25 * rng.standard_normal((N, H)))
    queries = _unit(centers[rng.integers(0, CENTERS, 12)] + 0.25 * rng.standard_normal((12, H)))
    return docs, queries


@pytest.fixture(scope="module")
def jax_files(corpus, tmp_path_factory):
    """One index file per storage dtype, built and written by the JAX package."""
    docs, _ = corpus
    out = tmp_path_factory.mktemp("jax_ivf")
    files = {}
    for dtype in ("float32", "bfloat16", "int8"):
        files[dtype] = out / f"ivf_{dtype}.npz"
        jivf.save_ivf(files[dtype], jivf.build_ivf(docs, num_clusters=32, iters=3,
                                                   storage_dtype=dtype))
    return files


def test_build_invariants(corpus):
    """As the JAX package's build: the ids partition the corpus, every
    tensor has one leading block axis, cap is a multiple of 128 near the
    mean cluster size, centroids are unit-norm, empty clusters take no
    block, and int8 blocks carry per-slot scales."""
    docs, _ = corpus
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("int8", torch.int8)):
        index = tivf.build_ivf(docs, num_clusters=32, iters=3, storage_dtype=dtype,
                               device="cpu")
        ids = index.ids.numpy()
        real = ids[ids >= 0]
        assert len(real) == N and len(set(real.tolist())) == N
        n_blocks = index.docs.shape[0]
        assert index.docs.shape == (n_blocks, index.cap, H) and index.docs.dtype == want
        assert index.centroids.shape == (n_blocks, H) and index.ids.shape == (n_blocks, index.cap)
        assert index.cap % 128 == 0
        assert (ids >= 0).any(axis=1).all()  # no all-padding block
        np.testing.assert_allclose(index.centroids.norm(dim=1).numpy(), 1.0, rtol=1e-4)
        assert (index.scales is not None) == (dtype == "int8")
        # every packed slot holds its own doc's row
        slot_rows = index.docs.float().numpy()[ids >= 0]
        if dtype == "int8":
            slot_rows = slot_rows * index.scales.numpy()[ids >= 0][:, None]
        np.testing.assert_allclose(slot_rows, docs[real], atol=1e-2 if dtype != "float32" else 0)


def test_lloyd_step_and_assignment_match_jax(corpus):
    """The same chunking, one Lloyd step from the same centroids (rtol
    1e-5) and the chunk assignment (identical ids)."""
    docs, _ = corpus
    rng = np.random.default_rng(1)
    cents = docs[rng.choice(N, 32, replace=False)]
    for n in (N, 300, 100):
        j_chunked = jivf._pad_to_chunks(jnp.asarray(docs[:n]))
        t_chunked = tivf._pad_to_chunks(torch.from_numpy(docs[:n]))
        assert tuple(t_chunked.shape) == j_chunked.shape
        np.testing.assert_array_equal(t_chunked.numpy(), np.asarray(j_chunked))
    j_chunked = jivf._pad_to_chunks(jnp.asarray(docs))
    t_chunked = tivf._pad_to_chunks(torch.from_numpy(docs))
    want = np.asarray(jivf._lloyd_step(j_chunked, jnp.asarray(cents), num_segments=32))
    got = tivf._lloyd_step(t_chunked, torch.from_numpy(cents), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for c in range(t_chunked.shape[0]):
        np.testing.assert_array_equal(
            tivf._assign_chunk(t_chunked[c], torch.from_numpy(want.copy())).numpy(),
            np.asarray(jivf._assign_chunk(j_chunked[c], jnp.asarray(want))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_search_over_a_jax_index_file_matches_jax(corpus, jax_files, dtype):
    """One .npz written by the JAX package, searched by both at nprobe 1,
    4 and the full probe: ids equal, scores within 1e-5 relative."""
    _, queries = corpus
    j_index = jivf.load_ivf(jax_files[dtype])
    t_index = tivf.load_ivf(jax_files[dtype])
    assert t_index.docs.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                  "int8": torch.int8}[dtype]
    C = int(t_index.centroids.shape[0])
    for nprobe in (1, 4, C):
        jv, ji = jivf.ivf_search(jnp.asarray(queries), j_index, k=10, nprobe=nprobe)
        tv, ti = tivf.ivf_search(torch.from_numpy(queries), t_index, k=10, nprobe=nprobe)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    # k beyond the probed columns: padded with -1 / -3e38, as JAX pads
    k = int(t_index.cap) + 5
    jv, ji = jivf.ivf_search(jnp.asarray(queries), j_index, k=k, nprobe=1)
    tv, ti = tivf.ivf_search(torch.from_numpy(queries), t_index, k=k, nprobe=1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[:, -5:] == -1).all() and (tv[:, -5:] <= -3e38).all()


def test_files_round_trip_both_ways(corpus, jax_files, tmp_path):
    """A file the JAX package wrote loads in the port and, written again by
    the port, loads in the JAX package with the same arrays, keys and
    dtypes (bf16 as a uint16 view); an index the port built does the same."""
    docs, _ = corpus
    for dtype, path in jax_files.items():
        again = tmp_path / f"again_{dtype}.npz"
        tivf.save_ivf(again, tivf.load_ivf(path))
        with np.load(path) as a, np.load(again) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])
        built = tivf.build_ivf(docs, num_clusters=32, iters=2, storage_dtype=dtype, device="cpu")
        ours = tmp_path / f"ours_{dtype}.npz"
        tivf.save_ivf(ours, built)
        j = jivf.load_ivf(ours)
        assert str(np.asarray(j.docs).dtype) == dtype and j.cap == built.cap
        np.testing.assert_array_equal(np.asarray(j.docs.astype(jnp.float32)),
                                      built.docs.float().numpy())
        np.testing.assert_array_equal(np.asarray(j.ids), built.ids.numpy())
        np.testing.assert_array_equal(np.asarray(j.centroids), built.centroids.numpy())
        assert (j.scales is None) == (built.scales is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_probe_equals_exact(corpus, dtype):
    """nprobe = C scores every slot: f32 blocks give the exact top-k's
    ids and scores; bf16 blocks the exact top-k over the bf16 corpus."""
    docs, queries = corpus
    index = tivf.build_ivf(docs, num_clusters=32, iters=3, storage_dtype=dtype, device="cpu")
    vals, ids = tivf.ivf_search(torch.from_numpy(queries), index, k=50,
                                nprobe=int(index.docs.shape[0]))
    stored = torch.from_numpy(docs).to(torch.bfloat16).float() if dtype == "bfloat16" \
        else torch.from_numpy(docs)
    q = torch.from_numpy(queries).to(index.docs.dtype).float()
    e_vals, e_ids = topk_oracle(q, stored, 50)
    np.testing.assert_array_equal(ids.numpy(), e_ids.numpy())
    np.testing.assert_allclose(vals.numpy(), e_vals.numpy(), rtol=1e-5)


def test_pick_nprobe_takes_jax_rung(corpus, jax_files):
    """On the same index file and probe queries, both packages walk the
    ladder to the same nprobe with the same measured recall, with the
    queries given and with the corpus rows they sample themselves."""
    docs, queries = corpus
    for dtype in ("float32", "int8"):
        j_index, t_index = jivf.load_ivf(jax_files[dtype]), tivf.load_ivf(jax_files[dtype])
        for kw in ({"queries": queries, "target_recall": 0.95},
                   {"num_queries": 64, "target_recall": 0.9, "seed": 3}):
            want = jivf.pick_nprobe(j_index, docs, k=10, **kw)
            got = tivf.pick_nprobe(t_index, docs, k=10, **kw)
            assert got == want, (dtype, kw)


def test_blocked_search_equals_one_call(corpus, jax_files, monkeypatch):
    """Queries in blocks sized to the gather's byte budget give one call's
    ids, down to one query a block, and its scores within 1e-6 relative (a
    product's summation order may change with the rows it is given)."""
    _, queries = corpus
    index = tivf.load_ivf(jax_files["bfloat16"])
    q = torch.from_numpy(queries)
    one = tivf.ivf_search(q, index, k=20, nprobe=8)
    per_query = 8 * index.cap * H * (2 + 4)
    for budget in (per_query * 5, 1):
        monkeypatch.setattr(tivf, "_SEARCH_BYTES", budget)
        blocked = tivf.ivf_search(q, index, k=20, nprobe=8)
        assert torch.equal(blocked[1], one[1])
        torch.testing.assert_close(blocked[0], one[0], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the IVF index served: artifacts, the engine, the index builder, HTTP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf_artifacts(synth_dir, tmp_path_factory):
    """An artifact directory exported by the JAX package with its prebuilt
    IVF index (f32 blocks, 8 clusters)."""
    import jax

    from twotowermlretrieval_tpu.data.loader import TripletBuilder
    from twotowermlretrieval_tpu.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu.tokenizer import Tokenizer
    from twotowermlretrieval_tpu.train.artifacts import save_inference_artifacts

    cfg = synthetic_config(synth_dir, hidden_dim=32, num_layers=1, bidirectional=True)
    tok = Tokenizer.from_pickle(cfg.word_to_idx_path)
    cfg = cfg.replace(vocab_size=tok.vocab_size(), embed_dim=16)
    datasets = TripletBuilder(cfg).load_datasets()
    params = init_two_tower(jax.random.key(0), TwoTowerSpec.from_config(cfg))
    out = tmp_path_factory.mktemp("ivf_art")
    save_inference_artifacts(out, params, cfg, tok, datasets, build_ivf_index=True,
                             ivf_storage_dtype="float32", ivf_num_clusters=8)
    return out, datasets


def test_engine_serves_the_jax_ivf_index_as_jax_does(ivf_artifacts):
    """``SearchEngine(index_type="ivf")`` loads the artifacts' ivf_index.npz
    (no k-means at boot) and answers with the JAX engine's documents and
    scores (1e-5) at the same nprobe."""
    from twotowermlretrieval_tpu.serve.engine import SearchEngine as JaxSearchEngine
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.artifacts import load_artifacts

    path, _ = ivf_artifacts
    assert load_artifacts(path).ivf_index is not None
    port = SearchEngine(path, device="cpu", storage_dtype="float32", index_type="ivf", nprobe=3)
    ref = JaxSearchEngine(path, storage_dtype="float32", index_type="ivf", nprobe=3)
    assert port.index.ivf is not None and port.index.nprobe == 3
    assert port.index.ivf.docs.shape == ref.index.ivf.docs.shape
    for q in ("t0w1 t0w2", "t3w4 t5w6 t5w7", "t7w2 t7w3 t2w1"):
        p, j = port.search(q, alpha=1.0), ref.search(q, alpha=1.0)
        assert [r["doc"] for r in p["results"]] == [r["doc"] for r in j["results"]]
        np.testing.assert_allclose([r["score"] for r in p["results"]],
                                   [r["score"] for r in j["results"]], rtol=1e-5)


def test_build_index_tool_persists_nprobe_and_the_engine_takes_it(ivf_artifacts, tmp_path):
    """``ttr-torch-build-index --target-recall`` writes ivf_index.npz and
    the measured nprobe with its signature; an engine with no ``nprobe``
    takes it, an explicit one wins, and a record for another corpus shape
    falls back to 16. The JAX package loads the file the tool wrote."""
    import shutil

    from twotowermlretrieval_tpu.ops.ivf import load_ivf as jax_load_ivf
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.serve.index import (
        load_retrieval_tuning,
        save_retrieval_tuning,
    )
    from twotowermlretrieval_tpu_torch.tools.build_index import main

    src, _ = ivf_artifacts
    art = tmp_path / "art"
    shutil.copytree(src, art)
    (art / tivf.IVF_INDEX_FILE).unlink()
    main([str(art), "--device", "cpu", "--clusters", "8", "--iters", "3",
          "--target-recall", "0.9", "--tune-k", "5", "--tune-queries", "32"])
    tuning = load_retrieval_tuning(art)
    emb = np.load(art / "document_embeddings.npy")
    assert tuning["nprobe_signature"] == {"num_docs": emb.shape[0], "dim": emb.shape[1],
                                          "storage_dtype": "bfloat16", "index_type": "ivf",
                                          "backend": "cpu"}
    assert tuning["nprobe_recall"]["measured"] >= 0.9 or tuning["nprobe"] == 8
    assert str(np.asarray(jax_load_ivf(art / tivf.IVF_INDEX_FILE).docs).dtype) == "bfloat16"
    engine = SearchEngine(art, device="cpu", index_type="ivf")
    assert engine.index.nprobe == tuning["nprobe"] and engine.index.ivf.docs.dtype == torch.bfloat16
    assert SearchEngine(art, device="cpu", index_type="ivf", nprobe=5).index.nprobe == 5
    save_retrieval_tuning(art, {"nprobe_signature": {**tuning["nprobe_signature"],
                                                     "num_docs": emb.shape[0] + 1}})
    assert SearchEngine(art, device="cpu", index_type="ivf").index.nprobe == 16


def test_port_export_carries_an_ivf_index_and_serves_it_over_http(ivf_artifacts, tmp_path):
    """``save_inference_artifacts(build_ivf_index=True)`` writes the seventh
    file (int8 blocks here), the JAX package loads it, and the port's HTTP
    server started as ``ttr-torch-serve --index-type ivf`` answers /search."""
    import urllib.request

    from twotowermlretrieval_tpu.ops.ivf import load_ivf as jax_load_ivf
    from twotowermlretrieval_tpu_torch.serve.app import serve
    from twotowermlretrieval_tpu_torch.train.artifacts import (
        load_artifacts,
        save_inference_artifacts,
    )

    path, datasets = ivf_artifacts
    loaded = load_artifacts(path)
    out = save_inference_artifacts(tmp_path / "port", loaded.params, loaded.config,
                                   loaded.tokenizer, datasets, device="cpu",
                                   build_ivf_index=True, ivf_storage_dtype="int8",
                                   ivf_num_clusters=8)
    j = jax_load_ivf(out / tivf.IVF_INDEX_FILE)
    assert j.scales is not None and str(np.asarray(j.docs).dtype) == "int8"
    server = serve(str(out), port=0, host="127.0.0.1", device="cpu", index_type="ivf",
                   nprobe=8)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/search"
        req = urllib.request.Request(url, data=json.dumps({"query": "t0w1 t0w2",
                                                           "alpha": 0.5}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert 0 < len(body["results"]) <= 10
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
