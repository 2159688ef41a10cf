"""The port's tools against the JAX package's: loadtest, prepare_embeddings,
inspect_data and download_dataset give the JAX tools' output where it is
deterministic; bench_rnn_variants, bench_f32_scans and the e2e demo run on
the CPU (``--device cpu``, the kernels' plain versions) at shrunk sizes."""

import json
import pickle
import re
import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from twotowermlretrieval_tpu.tools import download_dataset as jax_download
from twotowermlretrieval_tpu.tools import inspect_data as jax_inspect
from twotowermlretrieval_tpu.tools import loadtest as jax_loadtest
from twotowermlretrieval_tpu.tools import prepare_embeddings as jax_prepare
from twotowermlretrieval_tpu_torch.tools import (
    bench_f32_attention,
    bench_f32_scans,
    bench_rnn_stream,
)
from twotowermlretrieval_tpu_torch.tools import bench_rnn_variants as bench
from twotowermlretrieval_tpu_torch.tools import download_dataset, e2e_demo, inspect_data
from twotowermlretrieval_tpu_torch.tools import loadtest, prepare_embeddings, smoke_phase_times


def _run_main(monkeypatch, main, argv):
    """A tool's ``main()`` that reads sys.argv itself."""
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    return main()


# --------------------------------------------------------------------- loadtest


@pytest.mark.parametrize("vals", [[], [3.0], [5.0, 1.0, 9.0, 2.0, 7.0], list(range(101))])
def test_loadtest_percentile_and_summary_match_jax(vals):
    lat = sorted(float(v) for v in vals)
    for p in (0, 50, 90, 99, 100):
        a, b = loadtest.percentile(lat, p), jax_loadtest.percentile(lat, p)
        assert (np.isnan(a) and np.isnan(b)) or a == b
    server = [v / 2 for v in vals]
    if lat:  # an empty run's mean is 0 in both; its percentiles are nan
        assert (loadtest.summarize(vals, server, ["e"], 1.5, 4)
                == jax_loadtest.summarize(vals, server, ["e"], 1.5, 4))


@pytest.fixture(scope="module")
def cpu_server(synth_dir, tmp_path_factory):
    """The port's server on the CPU over a small export of the port."""
    from twotowermlretrieval_tpu.data.loader import TripletBuilder
    from twotowermlretrieval_tpu.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.serve.app import serve
    from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
    from twotowermlretrieval_tpu_torch.train.artifacts import save_inference_artifacts

    jcfg = synthetic_config(synth_dir, hidden_dim=16, num_layers=1, compute_dtype="float32")
    tok = Tokenizer.from_pickle(jcfg.word_to_idx_path)
    cfg = Config.from_dict(jcfg.replace(vocab_size=tok.vocab_size(), embed_dim=16).to_dict())
    params = init_two_tower(torch.Generator().manual_seed(0), TwoTowerSpec.from_config(cfg))
    out = tmp_path_factory.mktemp("port_export")
    save_inference_artifacts(out, params, cfg, tok, TripletBuilder(jcfg).load_datasets(),
                             device="cpu")
    server = serve(str(out), port=0, host="127.0.0.1", device="cpu", storage_dtype="float32")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("keep_alive", [False, True])
def test_loadtest_run_load_against_port_server(cpu_server, keep_alive):
    queries = ["t0w1 t0w2", "t3w4", "nothing known"]
    lats, server_ms, errors, wall = loadtest.run_load(cpu_server, queries, 12, 3, 0.5,
                                                      keep_alive=keep_alive)
    assert errors == [] and len(lats) == len(server_ms) == 12 and wall > 0
    summary = loadtest.summarize(lats, server_ms, errors, wall, 3)
    assert summary["requests"] == 12 and summary["errors"] == 0
    assert summary["client_ms"]["p50"] <= summary["client_ms"]["p99"]
    assert "server_took_ms" in summary


# ----------------------------------------------------------- prepare_embeddings


@pytest.mark.parametrize("special", [False, True], ids=["plain", "add-special"])
def test_prepare_embeddings_matches_jax(monkeypatch, tmp_path, special):
    rng = np.random.default_rng(5)
    words = ["the", ",", "cat", "naïve", "x_y", "42"]
    glove = tmp_path / "glove.txt"
    glove.write_text("".join(w + " " + " ".join(f"{v:.5f}" for v in rng.normal(size=6)) + "\n"
                             for w in words), encoding="utf-8")
    flag = ["--add_special"] if special else []
    _run_main(monkeypatch, prepare_embeddings.main, [str(glove), "--out", str(tmp_path / "p"),
                                                     *flag])
    _run_main(monkeypatch, jax_prepare.main, [str(glove), "--out", str(tmp_path / "j"), *flag])
    for name in ("embeddings.npy", "word_to_idx.pkl"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    with open(tmp_path / "p" / "word_to_idx.pkl", "rb") as f:
        assert ("<UNK>" in pickle.load(f)) == special


# ------------------------------------------------------------------ inspect_data


@pytest.mark.parametrize("argv", [["--suggest-buckets", "3"],
                                  ["--suggest-buckets", "2", "--max-rows", "50",
                                   "--splits", "train,test,nosuch"]])
def test_inspect_data_json_matches_jax(synth_dir, capsys, argv):
    argv = ["--data-dir", str(synth_dir), "--json", *argv]
    port = inspect_data.main(argv)
    port_out = capsys.readouterr().out
    ref = jax_inspect.main(argv)
    jax_out = capsys.readouterr().out
    assert port == ref and json.loads(port_out) == json.loads(jax_out)
    assert port["bucket_suggestion"]["LENGTH_BUCKETS"]


# -------------------------------------------------------------- download_dataset


def test_download_synthetic_matches_jax(monkeypatch, tmp_path):
    """--synthetic: the same parquet splits and table for the same
    (default) seed. The hub branch needs the network and the ``datasets``
    package; it is not run here."""
    _run_main(monkeypatch, download_dataset.main,
              ["--synthetic", "--num_queries", "40", "--out", str(tmp_path / "p")])
    _run_main(monkeypatch, jax_download.main,
              ["--synthetic", "--num_queries", "40", "--out", str(tmp_path / "j")])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    for name in names:
        a, b = tmp_path / "p" / name, tmp_path / "j" / name
        if name.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(a), pd.read_parquet(b))
        else:
            assert a.read_bytes() == b.read_bytes(), name


# ------------------------------------------------------------- bench_rnn_variants


@pytest.fixture
def small_bench(monkeypatch):
    """The bench at a CPU-sized shape (its logic unchanged)."""
    monkeypatch.setattr(bench, "H", 16)
    monkeypatch.setattr(bench, "SHAPES", {"query": (6, 8), "doc": (10, 16)})
    monkeypatch.setattr(bench, "QUERY_LEN", 8)
    monkeypatch.setattr(bench, "DOC_LEN", 12)
    monkeypatch.setattr(bench, "VOCAB", 300)
    windows = bench._alternating_windows
    monkeypatch.setattr(bench, "_alternating_windows",
                        lambda variants, run, n_long, n_rounds=7: windows(variants, run, 7, 2))


def test_bench_rnn_kernels_mode_on_cpu(small_bench, capsys, monkeypatch):
    res = bench.main(["--mode", "kernels", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and set(res) == {"query", "doc"}
    pat = re.compile(r"GRU (query|doc) \[T=\d+, rows=\d+\] bwd: combined ([\d.]+) ms \| "
                     r"hoisted ([\d.]+) ms \| split ([\d.]+) ms")
    # a time is a long window less the best short one, floored at 1e-9 s:
    # on a busy CPU it can print as 0.000
    for line in lines:
        m = pat.fullmatch(line)
        assert m and all(float(x) >= 0 for x in m.groups()[1:]), line
    assert all(v > 0 for r in res.values() for v in r.values())


def test_bench_rnn_history_mode_on_cpu(small_bench, capsys, monkeypatch):
    """Both arms run in one process, each under its own setting: the
    forward sees history_in_cdt False for f32 and True for cdt."""
    from twotowermlretrieval_tpu_torch.models import rnn as port_rnn

    seen = []
    fwd = port_rnn.rnn_layer_fwd

    def spy(*args, **kwargs):
        seen.append(kwargs["history_in_cdt"])
        return fwd(*args, **kwargs)

    monkeypatch.setattr(port_rnn, "rnn_layer_fwd", spy)
    monkeypatch.setenv("TTMR_RNN_HISTORY", "unchanged")
    per = bench.main(["--mode", "history", "--device", "cpu", "--batch", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert [re.match(r"history \[(\w+), B=8\]: [\d.]+ ms/step", ln).group(1)
            for ln in lines] == ["f32", "cdt"]
    assert set(per) == {"f32", "cdt"} and all(len(v) == 2 for v in per.values())
    assert True in seen and False in seen
    import os

    assert os.environ["TTMR_RNN_HISTORY"] == "unchanged"  # restored after each arm


def test_bench_rnn_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.main(["--mode", "kernels"])


# ----------------------------------------------------------------------- e2e demo


def test_e2e_demo_smoke_on_cpu(monkeypatch, tmp_path, capsys):
    """The whole demo on the CPU: data, the lr=0 baseline and the trained
    run (the recall assertion as written), the inflation, the int8 server
    as a child process, the load test and the result line. The smoke scale
    keeps its queries and tower; fewer filler documents and requests keep
    the run short."""
    smoke = dict(e2e_demo.SCALES["smoke"], corpus_docs=600, loadtest_requests=8)
    monkeypatch.setitem(e2e_demo.SCALES, "smoke", smoke)
    # one thread here and in the server child: the test runs beside other
    # test processes, and oversubscribed cores slow the plain loops tenfold
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e2e_demo.main(["--scale", "smoke", "--device", "cpu", "--out", str(tmp_path / "demo"),
                       "--log", str(tmp_path / "log.md")])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("E2E_DEMO_RESULT "))
    res = json.loads(line[len("E2E_DEMO_RESULT "):])
    assert res["recall10_trained"] > res["recall10_random"] + 0.1
    assert res["corpus_docs"] == 600 and res["scale"] == "smoke"
    for key in ("p50_ms_c1", "p99_ms_c1", "p50_ms_c8", "p99_ms_c8", "req_per_s_c8"):
        assert res[key] > 0
    # the CPU runs the plain versions: no stage launched a kernel
    assert set(res["launches"]) == {"train", "inflate", "serve"}
    assert all(n == 0 for counts in res["launches"].values() for n in counts.values())
    assert "device cpu" in res["device"]
    assert "E2E_DEMO_RESULT" in (tmp_path / "log.md").read_text()


def test_bench_f32_attention_on_cpu(tmp_path, capsys):
    """The f32 attention harness with the plain versions: a JSON line per
    shape (the toy shapes, a bf16-input one among them) whose kernel and
    plain version are the same function (no difference, repeatable), with
    times, the bound (the split products counted by operand dtype) and the
    library call; the --out list holds the same records."""
    out = tmp_path / "attn.json"
    assert bench_f32_attention.main(["--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == json.loads(out.read_text())
    assert [(r["R"], r["T"], r["hd"], r["input"]) for r in lines] == [
        (16, 16, 8, "float32"), (8, 33, 16, "float32"), (8, 33, 16, "bfloat16")]
    for r in lines:
        assert r["fwd_rel_err"] == 0 and r["bwd_rel_err"] == 0 and r["bitwise_repeatable"]
        assert r["compute"] == "float32" and r["card"] == "the host (plain versions)"
        for key in ("fwd_ms", "bwd_ms", "bf16_compute_fwd_ms", "sdpa_fwd_ms", "fwd_bound_ms",
                    "bwd_bound_ms"):
            assert r[key] > 0, key
        assert r["fwd_bound_by"] in ("bytes", "operations")
    # bf16 inputs: half the input bytes, and fewer split products
    f32_in, bf16_in = lines[1:]
    for name in ("fwd", "bwd"):
        assert bf16_in[f"{name}_bound_ms"] < f32_in[f"{name}_bound_ms"]


def test_smoke_phase_times_compare(tmp_path, capsys):
    """``--compare`` reads ``--kernel-phases`` files: each record both sides
    hold, by phase, kernel and shape (a phase's lone record too), placed by
    the new side's median against the base side's range; a record only one
    side holds is left out."""
    def write(name, segmax_ms, wide_ms, extra=False):
        recs = {"phase_kernels": {"segmax": [{"shape": "B=16", "ms": segmax_ms},
                                             {"shape": "B=1", "ms": 0.5}]},
                "phase_wide_s8": {"shape": "B=32", "ms": wide_ms, "rows": [1, 2]}}
        if extra:
            recs["phase_kernels"]["segmax"].append({"shape": "B=32", "ms": 9.0})
        path = tmp_path / name
        path.write_text(json.dumps({"records": recs}))
        return str(path)

    base = [write("p1.json", 1.0, 2.0), write("p2.json", 1.2, 2.1)]
    new = [write("c1.json", 1.3, 1.0, extra=True), write("c2.json", 1.4, 1.2)]
    assert smoke_phase_times.main(["--compare", *base, "--", *new]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"inside": 1, "faster": 1, "slower": 1}
    assert [line.split()[0] for line in lines[:-1]] == ["inside", "slower", "faster"]
    assert "new median 1.3500 ms base 1.0000-1.2000" in lines[1]


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_bench_f32_scans_on_cpu(tmp_path, storage):
    """The scans' harness with the plain versions, at each --storage: a
    record per shape whose kernel and plain version are the same function
    (no difference, the same ids, repeatable), with the digests of its
    outputs and its plan; --layouts times every layout, the
    plan's own marked once, each with the record's digest; then, at f32,
    the served f32 top-50 at B=1 and 16."""
    out = tmp_path / "scans.json"
    assert bench_f32_scans.main(["--device", "cpu", "--storage", storage, "--layouts",
                                 "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    scans = [r for r in recs if "segmax_err" in r]
    assert [(r["rows"], r["H"], r["B"]) for r in scans] == [(4096, 64, 1), (4096, 64, 16),
                                                           (2048, 320, 32)]
    for r in scans:
        assert r["segmax_err"] == 0 and r["topk_err"] == 0 and r["topk_ids_equal_plain"] == 1
        assert r["bitwise_repeatable"] and r["segmax_ms"] >= 0 and r["storage"] == storage
        assert r["card"] == "the host (plain versions)"
        assert len(r["segmax_digest"]) == len(r["topk_digest"]) == 64
        assert [p["rows"] for p in r["segmax_plan"]] == [r["B"]]
        for name, digest in (("segmax", r["segmax_digest"]), ("topk_stream", r["topk_digest"])):
            lays = [x for x in recs if x.get("layout") == name and (x["H"], x["B"]) == (
                r["H"], r["B"])]
            assert sum(x["chosen"] for x in lays) == 1
            assert all(x["digest"] == digest and x["ms"] > 0 for x in lays)
            routes = {x["query_frags"] for x in lays}
            assert routes == ({"ring"} if storage == "f32" else {"ring", "shared memory"})
    served = [r for r in recs if r.get("served_f32_top50")]
    assert [r["B"] for r in served] == ([1, 16] if storage == "f32" else [])
    assert all(r["ms_median"] > 0 for r in served)


def test_bench_rnn_stream_on_cpu(tmp_path, capsys):
    """The streamed-W harness with the plain versions: a JSON line per toy
    shape, both passes, whose kernel and plain version are the same
    function (no difference, the same digest twice), with the plan, the
    bound and the W bytes a CTA draws a step (none where W is resident);
    --layouts times every layout of the wide shapes and of the f32 ones,
    the plan's own among them, all with the plan's bits."""
    out = tmp_path / "stream.json"
    assert bench_rnn_stream.main(["--device", "cpu", "--layouts", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == json.loads(out.read_text())
    assert [(r["pass"], r["cell"], r["H"]) for r in lines] == [
        ("fwd", "GRU", 24), ("fwd", "LSTM", 40), ("bwd", "GRU", 24), ("bwd", "RNN", 16),
        ("fwd", "GRU", 512), ("bwd", "GRU", 1024)]
    for r in lines:
        assert r["max_abs_err"] == 0 and r["bitwise_repeatable"] and len(r["digest"]) == 64
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["w_bytes_cta_step"] == (0 if r["plan"]["resident"] else
                                         r["plan"]["hc"] * r["H"] * {"GRU": 3, "LSTM": 4,
                                                                    "RNN": 1}[r["cell"]] * 2)
        assert r["card"] == "the host (plain versions)" and r["cudnn_ms"] is None
        # every f32 shape is swept, W held f32 or in its bf16 pieces
        assert ("layouts" in r) == (r["H"] > 256 or r["compute"] == "float32")
        if r["compute"] == "float32":
            assert {lay["plan"]["wsplit"] for lay in r["layouts"]} == {False, True}
            assert all(lay["same_bits"] for lay in r["layouts"])
    fwd, bwd = lines[4:]
    assert fwd["plan"]["resident"] and fwd["plan"]["nc"] == 16  # resident in clusters of 16
    assert not bwd["plan"]["resident"] and bwd["plan"]["wstages"] >= 1
    for r in (fwd, bwd):
        assert sum(lay["chosen"] for lay in r["layouts"]) == 1
        assert all(lay["same_bits"] and lay["ms"] > 0 for lay in r["layouts"])
    # the forward's clusters of 8 stream W through rings of every depth
    eights = [lay["plan"] for lay in fwd["layouts"] if lay["plan"]["nc"] == 8]
    assert eights and all(not p["resident"] and p["wstages"] >= 2 for p in eights)
    assert {p["blocks"] for p in eights} == {1, 2}
