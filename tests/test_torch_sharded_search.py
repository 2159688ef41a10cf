"""The port's sharded search (``parallel/topk.py``, ``parallel/ivf.py``, a
``RetrievalIndex`` and an HTTP server over a ``DeviceMesh``) against the
JAX package's on its 8-device virtual CPU mesh (``tests/conftest.py``),
with ``use_pallas=False`` there and the same numpy inputs from a seed.

The port's mesh is eight shards on the CPU (a device list may repeat a
device). Tolerances: f32 ids equal to JAX's and to the oracle's, scores
within 1e-5 relative (f32 sums of the same products, in another order);
the per-row int8 corpus, ids equal and scores 1e-5 relative (bf16 query
times int8 values, exact, then the scale); s8 and IVF over the same index
file, ids equal and s8 scores bit for bit, IVF scores 1e-5 relative. A
sharded index or server against the port's single-device one: ids and
documents equal, scores within 1e-6 absolute (the same arithmetic a
shard, so in practice the same bits).
"""

import json
import signal
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops import ivf as jivf
from twotowermlretrieval_tpu.ops.topk import topk_oracle as jax_topk_oracle
from twotowermlretrieval_tpu.parallel import ivf as jpivf
from twotowermlretrieval_tpu.parallel import topk as jptopk
from twotowermlretrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from twotowermlretrieval_tpu.serve.index import RetrievalIndex as JaxRetrievalIndex
from twotowermlretrieval_tpu_torch.ops import ivf as tivf
from twotowermlretrieval_tpu_torch.ops import topk as ttopk
from twotowermlretrieval_tpu_torch.ops.topk import NEG_INF
from twotowermlretrieval_tpu_torch.parallel import ivf as tpivf
from twotowermlretrieval_tpu_torch.parallel import topk as tptopk
from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
from twotowermlretrieval_tpu_torch.serve import app as tapp
from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

D = 8
RTOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    jmesh = jax_make_mesh(data=D, model=1)
    assert dict(jmesh.shape) == {"data": D, "model": 1}
    return make_device_mesh(D, 1, ["cpu"] * D), jmesh


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _case(name):
    """(queries, docs, k) of the JAX package's tests/test_parallel.py cases."""
    if name == "oracle":  # 1000 rows: not a multiple of the shard count's tile
        rng = np.random.default_rng(5)
        q, d = _unit(rng.normal(size=(4, 16))), _unit(rng.normal(size=(1000, 16)))
        return q, d, 20
    if name == "all_negative":  # padding rows must not leak in
        rng = np.random.default_rng(6)
        q = -np.abs(rng.normal(size=(2, 8))).astype(np.float32)
        return q, np.abs(rng.normal(size=(333, 8))).astype(np.float32), 5
    if name == "k_beyond_shard":  # 13 rows a shard, k 50
        rng = np.random.default_rng(8)
        return (rng.standard_normal((4, 16)).astype(np.float32),
                rng.standard_normal((100, 16)).astype(np.float32), 50)
    # padding never displaces real docs: 1003 rows (5 zero rows in the tail
    # shard), queries anti-aligned so every real score is negative
    rng = np.random.default_rng(0)
    docs = _unit(np.abs(rng.standard_normal((1003, 64))))
    return -np.abs(rng.standard_normal((8, 64))).astype(np.float32), docs, 10


@pytest.mark.parametrize("use_kernel,phase2,sort_candidates", [
    (None, "rescore", False), (True, "rescore", False), (True, "gather", True)])
@pytest.mark.parametrize("name", ["oracle", "all_negative", "k_beyond_shard", "padding"])
def test_distributed_topk_matches_jax_and_the_oracle(meshes, name, use_kernel, phase2,
                                                     sort_candidates):
    """Each shard on the two-phase route (use_kernel None on the CPU) or
    the fused route (its plain versions), phase 2 re-scoring or gathering
    sorted candidates: ids equal to JAX's sharded search and to the
    oracle's, values within 1e-5."""
    mesh, jmesh = meshes
    q, d, k = _case(name)
    shards, n_valid = tptopk.shard_corpus(d, mesh)
    vals, ids = tptopk.distributed_topk(torch.from_numpy(q), shards, k, mesh, n_valid=n_valid,
                                        use_kernel=use_kernel, phase2=phase2,
                                        sort_candidates=sort_candidates)
    j_sh, j_n = jptopk.shard_corpus(d, jmesh)
    j_vals, j_ids = jptopk.distributed_topk(jnp.asarray(q), j_sh, k=k, mesh=jmesh, n_valid=j_n,
                                            use_pallas=False)
    r_vals, r_ids = jax_topk_oracle(jnp.asarray(q), jnp.asarray(d), k)
    assert vals.shape == ids.shape == (q.shape[0], k) and ids.dtype == torch.int32
    for want_vals, want_ids in ((j_vals, j_ids), (r_vals, r_ids)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=RTOL, atol=1e-6)
    assert ((ids >= 0) & (ids < d.shape[0])).all()
    if name == "all_negative":
        assert (vals < 0).all()


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("N", [1000, 20])
def test_distributed_topk_int8_matches_jax(meshes, N, use_kernel):
    """The per-row int8 corpus over 8 shards (N=20: 8 rows a shard,
    shards 3-7 padding only) against JAX's sharded search and the
    unsharded two-phase search over the same quantized rows."""
    from twotowermlretrieval_tpu.ops.topk import quantize_rows, topk_segmented_int8

    mesh, jmesh = meshes
    rng = np.random.default_rng(0)
    docs = _unit(rng.standard_normal((N, 64)))
    q = rng.standard_normal((8, 64)).astype(np.float32)
    k = min(10, N)
    values, scales, n_valid = tptopk.shard_corpus_int8(docs, mesh)
    vals, ids = tptopk.distributed_topk_int8(torch.from_numpy(q), values, scales, k, mesh,
                                             n_valid=n_valid, use_kernel=use_kernel)
    jv, js, jn = jptopk.shard_corpus_int8(docs, jmesh)
    dv, di = jptopk.distributed_topk_int8(jnp.asarray(q), jv, js, k=k, mesh=jmesh, n_valid=jn,
                                          use_pallas=False)
    lv, li = topk_segmented_int8(jnp.asarray(q), *map(jnp.asarray, quantize_rows(docs)), k=k)
    for want_vals, want_ids in ((dv, di), (lv, li)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("use_kernel,phase2,sort_candidates", [
    (None, "rescore", False), (True, "rescore", False), (True, "gather", True)])
@pytest.mark.parametrize("N", [1000, 9000])
def test_distributed_topk_s8_equals_jax_bitwise(meshes, N, use_kernel, phase2, sort_candidates):
    """The per-segment int8 (serving) corpus: ids and values bit for bit
    JAX's sharded search and the port's single-device index. N=1000 pads
    to 1024 rows a shard, so shards 1-7 hold padding only."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(22)
    docs = _unit(rng.normal(size=(N, 32)))
    q = rng.normal(size=(5, 32)).astype(np.float32)
    values, scales, n_valid = tptopk.shard_corpus_s8(docs, mesh)
    vals, ids = tptopk.distributed_topk_s8(torch.from_numpy(q), values, scales, 20, mesh,
                                           n_valid=n_valid, use_kernel=use_kernel,
                                           phase2=phase2, sort_candidates=sort_candidates)
    jv, js, jn = jptopk.shard_corpus_s8(docs, jmesh)
    j_vals, j_ids = jptopk.distributed_topk_s8(jnp.asarray(q), jv, js, k=20, mesh=jmesh,
                                               n_valid=jn, use_pallas=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    one_vals, one_ids = RetrievalIndex(docs, "int8", device="cpu").search(q, 20)
    np.testing.assert_array_equal(ids.numpy(), one_ids)
    np.testing.assert_array_equal(vals.numpy(), one_vals)


def test_a_padding_only_shard_returns_nothing(meshes):
    """A shard holding only padding (local n_valid 0) returns NEG_INF and
    id -1 on both routes and for each storage."""
    mesh, _ = meshes
    docs = _unit(np.random.default_rng(3).normal(size=(20, 16)))  # 8 rows a shard: 8, 8, 4, 0...
    q = torch.from_numpy(_unit(np.random.default_rng(4).normal(size=(3, 16))))
    shards, _ = tptopk.shard_corpus(docs, mesh)
    values, scales, _ = tptopk.shard_corpus_int8(docs, mesh)
    s8_values, s8_scales, _ = tptopk.shard_corpus_s8(docs, mesh)
    for search, args in ((ttopk.fused_topk_segmax, (shards[5],)),
                         (ttopk.topk_segmented, (shards[5],)),
                         (ttopk.fused_topk_int8, (values[5], scales[5])),
                         (ttopk.topk_segmented_int8, (values[5], scales[5])),
                         (ttopk.fused_topk_segmax_s8, (s8_values[1], s8_scales[1])),
                         (ttopk.topk_segmented_s8, (s8_values[1], s8_scales[1]))):
        vals, ids = search(q, *args, k=8, n_valid=0)
        assert (vals == NEG_INF).all() and (ids == -1).all(), search.__name__


@pytest.mark.parametrize("N", [1000, 100, 70_000])
@pytest.mark.parametrize("kind", ["float32", "int8_rows", "s8"])
def test_shard_corpus_places_what_jax_places(meshes, kind, N):
    """Per-shard shapes, the true N and every value equal JAX's sharded
    arrays split in eight."""
    mesh, jmesh = meshes
    docs = _unit(np.random.default_rng(N).normal(size=(N, 8)))
    if kind == "float32":
        (shards, n), (j_arrays, jn) = (tptopk.shard_corpus(docs, mesh),
                                       jptopk.shard_corpus(docs, jmesh))
        got, want = [shards], [j_arrays]
    else:
        fn = "shard_corpus_int8" if kind == "int8_rows" else "shard_corpus_s8"
        values, scales, n = getattr(tptopk, fn)(docs, mesh)
        jv, js, jn = getattr(jptopk, fn)(docs, jmesh)
        got, want = [values, scales], [jv, js]
    assert n == jn == N
    for shards, j_array in zip(got, want):
        whole = np.asarray(j_array)
        assert len(shards) == D and all(s.device.type == "cpu" for s in shards)
        assert {tuple(s.shape) for s in shards} == {(whole.shape[0] // D,) + whole.shape[1:]}
        np.testing.assert_array_equal(torch.cat(shards).numpy(), whole)


@pytest.fixture(scope="module")
def ivf_files(tmp_path_factory):
    """Clustered rows and one IVF index file a storage dtype, built and
    written by the JAX package (22 clusters: padding blocks on 8 shards)."""
    rng = np.random.default_rng(0)
    centers = _unit(rng.standard_normal((16, 16)))
    docs = _unit(centers[rng.integers(0, 16, 1536)] + 0.25 * rng.standard_normal((1536, 16)))
    queries = _unit(centers[rng.integers(0, 16, 6)] + 0.25 * rng.standard_normal((6, 16)))
    out = tmp_path_factory.mktemp("jax_ivf_sharded")
    files = {}
    for dtype in ("float32", "bfloat16", "int8"):
        files[dtype] = out / f"ivf_{dtype}.npz"
        jivf.save_ivf(files[dtype], jivf.build_ivf(docs, num_clusters=22, iters=3,
                                                   storage_dtype=dtype))
    return docs, queries, files


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_distributed_ivf_search_matches_jax(meshes, ivf_files, dtype):
    """One .npz written by the JAX package, sharded by both and searched at
    nprobe 1, 4 and the full probe: ids equal to JAX's sharded search and
    to the port's single-device ``ivf_search``, scores within 1e-5; k past
    the probed rows pads with -1 and -3e38 as JAX pads."""
    mesh, jmesh = meshes
    _, queries, files = ivf_files
    j_sharded = jpivf.shard_ivf(jivf.load_ivf(files[dtype]), jmesh)
    t_index = tivf.load_ivf(files[dtype])
    t_sharded = tpivf.shard_ivf(t_index, mesh)
    C = int(t_index.centroids.shape[0])
    assert t_sharded.n_blocks == j_sharded.n_blocks == C and C % D
    assert t_sharded.docs[0].shape == (-(-C // D), t_index.cap, 16)
    q = torch.from_numpy(queries)
    for nprobe, k in ((1, 10), (4, 10), (C, 10), (1, t_index.cap + 5)):
        vals, ids = tpivf.distributed_ivf_search(q, t_sharded, k=k, nprobe=nprobe, mesh=mesh)
        j_vals, j_ids = jpivf.distributed_ivf_search(jnp.asarray(queries), j_sharded, k=k,
                                                     nprobe=nprobe, mesh=jmesh)
        one_vals, one_ids = tivf.ivf_search(q, t_index, k=k, nprobe=nprobe)
        for want_vals, want_ids in ((j_vals, j_ids), (one_vals, one_ids)):
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=RTOL)
    assert (ids[:, -5:] == -1).all() and (vals[:, -5:] <= -3e38).all()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "ivf"])
def test_index_over_a_mesh_equals_one_device(meshes, storage):
    """RetrievalIndex(mesh=...) against the port's single-device index (ids
    equal, scores within 1e-6) and JAX's index over its 8-device mesh."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(21)
    docs = _unit(rng.normal(size=(3000, 32)))
    q = rng.normal(size=(5, 32)).astype(np.float32)
    if storage == "ivf":
        one = RetrievalIndex(docs, "float32", device="cpu", index_type="ivf", num_clusters=20,
                             nprobe=6)
        sharded = RetrievalIndex(docs, "float32", mesh=mesh, ivf_index=one.ivf, nprobe=6)
        assert isinstance(sharded.ivf, tpivf.ShardedIVF) and sharded.index_type == "ivf"
        jax_index = JaxRetrievalIndex(docs, "float32", mesh=jmesh, ivf_index=jivf.IVFIndex(
            *(jnp.asarray(t.numpy()) if torch.is_tensor(t) else t for t in one.ivf)), nprobe=6)
    else:
        one = RetrievalIndex(docs, storage, device="cpu")
        sharded = RetrievalIndex(docs, storage, mesh=mesh)
        assert len(sharded._docs) == D and sharded.kernel_on() is False
        jax_index = JaxRetrievalIndex(docs, storage, mesh=jmesh, use_pallas=False)
    assert sharded.device.type == "cpu" and sharded.autotune() == {}
    assert sharded.tuning_signature() == one.tuning_signature()
    vals, ids = sharded.search(q, 20)
    o_vals, o_ids = one.search(q, 20)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(vals, o_vals, rtol=0, atol=1e-6)
    j_vals, j_ids = jax_index.search(q, 20)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(vals, j_vals, rtol=0 if storage == "int8" else RTOL,
                               atol=0 if storage == "int8" else 1e-6)
    if storage != "ivf":  # a persisted decision sets each shard's phase 2
        sharded.apply_decision({"phase2": "gather", "sort_candidates": True, "use_pallas": True})
        assert sharded.kernel_on()
        g_vals, g_ids = sharded.search(q, 20)
        np.testing.assert_array_equal(g_ids, o_ids)
        np.testing.assert_allclose(g_vals, o_vals, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# serving over the mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts_dir(synth_dir, tmp_path_factory):
    """A JAX-exported artifact directory with its prebuilt IVF index (f32
    blocks, 8 clusters)."""
    from twotowermlretrieval_tpu.data.loader import TripletBuilder
    from twotowermlretrieval_tpu.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu.tokenizer import Tokenizer
    from twotowermlretrieval_tpu.train.artifacts import save_inference_artifacts

    cfg = synthetic_config(synth_dir, hidden_dim=32, num_layers=1, bidirectional=True)
    tok = Tokenizer.from_pickle(cfg.word_to_idx_path)
    cfg = cfg.replace(vocab_size=tok.vocab_size(), embed_dim=16)
    params = init_two_tower(jax.random.key(0), TwoTowerSpec.from_config(cfg))
    out = tmp_path_factory.mktemp("sharded_art")
    save_inference_artifacts(out, params, cfg, tok, TripletBuilder(cfg).load_datasets(),
                             build_ivf_index=True, ivf_storage_dtype="float32",
                             ivf_num_clusters=8)
    return out


def _post(url, payload):
    req = urllib.request.Request(url + "/search", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("index_type", ["exact", "ivf"])
def test_http_mesh_serving_matches_single_device(artifacts_dir, index_type):
    """serve() with the corpus split over 8 shards, the path of
    ``ttr-torch-serve --device cpu --mesh-data 8``: every HTTP search
    returns the single-device engine's ranked docs and scores."""
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine

    kwargs = {"index_type": index_type, "storage_dtype": "float32", "device": "cpu"}
    if index_type == "ivf":
        kwargs["nprobe"] = 8
    mesh = tapp.build_serving_mesh(8, 1, "cpu")
    server = tapp.serve(str(artifacts_dir), port=0, host="127.0.0.1", mesh=mesh, **kwargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        engine = server.RequestHandlerClass.engine
        assert engine.index.mesh is mesh and engine.index.index_type == index_type
        single = SearchEngine(artifacts_dir, **kwargs)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        for query, alpha in [("t0w1 t0w2 t0w3", 0.7), ("t3w1 t3w5", 1.0), ("t1w2", 0.3)]:
            status, got = _post(url, {"query": query, "alpha": alpha})
            want = single.search(query, alpha=alpha)
            assert status == 200 and got["results"]
            assert [r["doc"] for r in got["results"]] == [r["doc"] for r in want["results"]]
            np.testing.assert_allclose([r["score"] for r in got["results"]],
                                       [r["score"] for r in want["results"]], rtol=0, atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_build_serving_mesh_resolution(monkeypatch):
    """1x1 is the single-device path; on the CPU every shard is the CPU and
    -1 counts it once; on cuda the first data x model cards, -1 taking
    every card not on 'model', too many raising a ValueError naming the
    count; a cuda mesh without a card raises."""
    assert tapp.build_serving_mesh(1, 1, "cpu") is None
    assert tapp.build_serving_mesh(-1, 1, "cpu") is None
    mesh = tapp.build_serving_mesh(4, 1, "cpu")
    assert mesh.shape == {"data": 4, "model": 1} and len(mesh.shard_devices) == 4
    mesh = tapp.build_serving_mesh(2, 2, "cpu")
    assert mesh.shape == {"data": 2, "model": 2} and len(mesh.devices) == 4
    assert len(mesh.shard_devices) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapp.build_serving_mesh(2, 1, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_device_mesh(2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tapp.build_serving_mesh(-1, 1, "cuda")
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.lead == torch.device("cuda", 0)
    mesh = tapp.build_serving_mesh(-1, 2, "cuda")
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.shard_devices == (torch.device("cuda", 0), torch.device("cuda", 2))
    with pytest.raises(ValueError, match="needs 8 devices but only 4 are visible"):
        tapp.build_serving_mesh(4, 2, "cuda")
    with pytest.raises(ValueError, match="mesh 3x1 != 2 devices"):
        make_device_mesh(3, 1, ["cuda:0", "cuda:1"])


def test_cli_flags_reach_the_engine(monkeypatch):
    """``ttr-torch-serve --device cpu --mesh-data 4 --mesh-model 1`` hands
    serve() a 4-shard CPU mesh; the default is the single-device path."""
    seen = []

    class FakeServer:
        RequestHandlerClass = types.SimpleNamespace(
            drain=types.SimpleNamespace(draining=threading.Event(), wait_idle=lambda t: True,
                                        inflight=0),
            engine=types.SimpleNamespace(close=lambda: None))

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def fake_serve(path, **kwargs):
        seen.append(kwargs["mesh"])
        return FakeServer()

    monkeypatch.setattr(tapp, "serve", fake_serve)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    for argv in (["-a", "x", "--device", "cpu", "--mesh-data", "4", "--mesh-model", "1"],
                 ["-a", "x", "--device", "cpu"]):
        monkeypatch.setattr("sys.argv", ["ttr-torch-serve"] + argv)
        tapp.main()
    assert seen[0].shape == {"data": 4, "model": 1} and seen[1] is None


def test_search_trace_reader_splits_the_shards(tmp_path):
    """``read_search_trace`` over a hand-made trace of two searches of two
    shards on one card: each device event goes to the shard whose scan
    launch last preceded its own, and the busy share, per-shard host and
    device times, the card's gap before each scan and the host's one wait
    come out exact."""
    from twotowermlretrieval_tpu_torch.tools.bench_sharded_search import read_search_trace

    # (host launch us, device start us, device us, name) of one search at t = 0
    work = [(5, 8, 2, "Memcpy HtoD"), (10, 12, 10, "void segmax_mma_kernel<16>()"),
            (20, 25, 5, "gather_kernel"), (50, 55, 10, "void segmax_mma_kernel<16>()"),
            (60, 66, 4, "topk_kernel"), (90, 95, 10, "sort_kernel")]
    events, corr = [], 0
    for t0 in (0, 1000):
        events.append({"ph": "X", "cat": "user_annotation", "name": f"sharded search {t0 // 1000}",
                       "ts": t0, "dur": 100})
        for launch, start, dur, name in work:
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": t0 + launch, "dur": 1, "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "gpu_memcpy" if name.startswith("Memcpy") else
                           "kernel", "name": name, "ts": t0 + start, "dur": dur,
                           "args": {"correlation": corr, "device": 0}})
        corr += 1  # one wait for the card inside each search
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                       "ts": t0 + 70, "dur": 3, "args": {"correlation": corr}})
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = read_search_trace(path, searches=2, shards=2)
    assert got["host_ms"] == pytest.approx(0.1) and got["device_span_ms"] == pytest.approx(0.097)
    assert got["busy_ms"] == pytest.approx(0.041)
    assert got["busy_share"] == pytest.approx(41 / 97)
    assert got["device_busy_ms"] == {"0": pytest.approx(0.041)}
    assert got["shard_host_ms"] == pytest.approx([0.04, 0.05])
    assert got["shard_busy_ms"] == pytest.approx([0.015, 0.024])
    assert got["scan_start_ms"] == pytest.approx([0.004, 0.047])
    assert got["gap_before_scan_ms"] == pytest.approx([0.0, 0.025])
    assert got["pre_busy_ms"] == pytest.approx(0.002)
    assert got["host_waits"] == 1 and got["host_wait_ms"] == pytest.approx(0.003)
    with pytest.raises(ValueError, match="expected 4"):
        read_search_trace(path, searches=2, shards=4)
