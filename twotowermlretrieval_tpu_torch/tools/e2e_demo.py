#!/usr/bin/env python3
"""One-command flagship demo of the PyTorch/CUDA port at reference scale.

The port's twin of the JAX package's ``tools/e2e_demo.py``, with the same
scales and stages: it generates a GloVe-sized synthetic setup (a
400k-row frozen table, MS MARCO-like lengths), then runs the whole
pipeline as one process tree on the card:

    generate -> train (reference GRU config) -> recall@10 vs a
    random-init baseline -> export -> inflate the corpus to 1M docs through
    the doc tower -> ttr-torch-serve (int8 exact index, micro-batching) ->
    loadtest (c=1 and c=8) -> one E2E_DEMO_RESULT JSON line

Usage:
    ttr-torch-e2e-demo --out DIR [--scale smoke|full] [--device cuda|cpu] [--log FILE]

``--scale smoke`` shrinks every knob for quick checks; ``--scale full``
(the default) is the flagship: a 400k vocabulary and a 1M-doc corpus.
``--device cpu`` runs the kernels' plain PyTorch versions (no card).
The result line also holds the kernel launches of each stage: training,
the inflation, and the server's (read from its log at shutdown).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

SCALES = {
    # vocab 400k (2000 topics x 200 words) ~ GloVe 6B's 400k rows
    "full": dict(num_queries=20_000, num_topics=2_000, words_per_topic=200,
                 embed_dim=100, corpus_docs=1_000_000, epochs=2,
                 loadtest_requests=200),
    "smoke": dict(num_queries=200, num_topics=20, words_per_topic=30,
                  embed_dim=32, corpus_docs=2_000, epochs=1,
                  loadtest_requests=20),
}

_LAUNCHES_LINE = "kernel launches: "  # serve/app.py prints it at shutdown


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log(lines, msg):
    print(msg, flush=True)
    lines.append(msg)


def _card(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or the device name
    when the demo runs on the CPU."""
    import torch

    if not device.startswith("cuda"):
        return f"device {device} (the kernels' plain PyTorch versions)"
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    limit = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi unavailable"
    return f"{torch.cuda.get_device_name(0)} ({limit})"


def _server_launches(log_path: Path) -> dict:
    for line in reversed(log_path.read_text().splitlines()):
        if line.startswith(_LAUNCHES_LINE):
            return json.loads(line[len(_LAUNCHES_LINE):])
    raise RuntimeError("the server's log holds no kernel launch counts: "
                       + log_path.read_text()[-2000:])


def run_demo(out: Path, scale: str, lr: float, log_path: Path | None,
             device: str = "cuda") -> dict:
    from twotowermlretrieval_tpu_torch.data.synthetic import (
        generate_corpus,
        generate_filler_documents,
        synthetic_config,
    )
    from twotowermlretrieval_tpu_torch.ops import launch_counts
    from twotowermlretrieval_tpu_torch.train.loop import train
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    resolve_device(device)  # no card: raise before any work
    p = SCALES[scale]
    lines: list = []
    launches = {}
    t_start = time.time()
    out.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- 1. data
    t0 = time.time()
    corpus = out / "corpus"
    generate_corpus(
        corpus, num_queries=p["num_queries"], num_topics=p["num_topics"],
        words_per_topic=p["words_per_topic"], embed_dim=p["embed_dim"],
        passages_per_query=4,
        query_len_range=(3, 9), passage_len_range=(40, 90),  # MS MARCO-like
    )
    vocab_rows = p["num_topics"] * p["words_per_topic"] + 5
    _log(lines, f"[1] synthetic corpus: {p['num_queries']} queries x 4 passages, "
                f"{vocab_rows}-row frozen table ({p['embed_dim']}d) "
                f"in {time.time() - t0:.0f}s")

    # ------------------------------------ 2. reference-config training run
    # the reference configuration: GRU 2-layer bidirectional H=256, frozen
    # table, B=64, margin 0.5, clip 1.0 (Config defaults)
    cfg = synthetic_config(
        corpus, hidden_dim=256, num_layers=2, bidirectional=True,
        dropout=0.2, batch_size=64, epochs=p["epochs"], lr=lr,
        max_query_len=16, max_doc_len=128, compute_dtype="bfloat16",
    )
    t0 = time.time()
    baseline = train(cfg.replace(lr=0.0, epochs=1), output_root=out / "baseline",
                     run_name="random-baseline", device=device)
    base_recall = baseline["epochs"][-1]["batch_Recall@10"]
    _log(lines, f"[2a] random-init baseline (lr=0 epoch): "
                f"recall@10 {base_recall:.4f}, MRR "
                f"{baseline['epochs'][-1]['batch_MRR']:.4f} "
                f"({time.time() - t0:.0f}s)")

    t0 = time.time()
    before = launch_counts()
    res = train(cfg, output_root=out / "artifacts", run_name="e2e-demo", device=device)
    launches["train"] = {k: v - before[k] for k, v in launch_counts().items()}
    last = res["epochs"][-1]
    trained_recall = last["batch_Recall@10"]
    # a run of one dispatch group has no steady window: its overall rate
    steady = res.get("steady_examples_per_sec") or res["examples_per_sec"]
    _log(lines, f"[2b] trained {p['epochs']} epoch(s) @ {steady:,.0f} ex/s steady: "
                f"recall@10 {trained_recall:.4f}, MRR {last['batch_MRR']:.4f}, "
                f"corpus recall@10 {last.get('corpus_Recall@10', float('nan')):.4f} "
                f"({time.time() - t0:.0f}s incl. "
                f"{res.get('compile_seconds', float('nan')):.0f}s first group)")
    assert trained_recall > base_recall + 0.1, (
        f"training failed to beat random init: {trained_recall} vs {base_recall}")
    art = Path(res["artifacts_dir"])

    # --------------------------- 3. inflate the corpus to serving scale
    # Filler docs are encoded through the trained doc tower via the public
    # inferencer API: the exported directory stays a faithful contract
    # (documents.pkl / document_embeddings.npy / tfidf_artifacts.pkl).
    from twotowermlretrieval_tpu_torch.ops.tfidf import TfidfVectorizer
    from twotowermlretrieval_tpu_torch.serve.inferencer import QueryInferencer

    t0 = time.time()
    with open(art / "documents.pkl", "rb") as f:
        docs = pickle.load(f)
    n_fill = max(p["corpus_docs"] - len(docs), 0)
    filler = generate_filler_documents(
        n_fill, p["num_topics"], p["words_per_topic"], len_range=(40, 90))
    _log(lines, f"[3a] generated {n_fill} filler docs "
                f"({time.time() - t0:.0f}s)")
    t0 = time.time()
    before = launch_counts()
    inf = QueryInferencer(art, device=device)
    fill_emb = inf.get_document_embeddings(filler)
    launches["inflate"] = {k: v - before[k] for k, v in launch_counts().items()}
    emb = np.concatenate(
        [np.load(art / "document_embeddings.npy"), fill_emb], axis=0)
    docs = list(docs) + filler
    del inf
    _log(lines, f"[3b] doc tower encoded {n_fill} docs -> [{emb.shape[0]}, "
                f"{emb.shape[1]}] ({time.time() - t0:.0f}s, "
                f"{n_fill / max(time.time() - t0, 1e-9):,.0f} docs/s incl. fetch)")
    t0 = time.time()
    serve_art = out / "artifacts_serving"
    if serve_art.exists():
        shutil.rmtree(serve_art)
    shutil.copytree(art, serve_art)
    np.save(serve_art / "document_embeddings.npy", emb)
    with open(serve_art / "documents.pkl", "wb") as f:
        pickle.dump(docs, f)
    vec = TfidfVectorizer(max_features=20_000)
    mat = vec.fit_transform(docs)
    with open(serve_art / "tfidf_artifacts.pkl", "wb") as f:
        pickle.dump({"vectorizer": vec, "matrix": mat}, f)
    _log(lines, f"[3c] serving artifacts: {len(docs)} docs, TF-IDF refit "
                f"({time.time() - t0:.0f}s)")

    # ------------------------------------------------- 4. serve + loadtest
    port = _free_port()
    t0 = time.time()
    # the child needs the package importable from a bare checkout: prepend
    # the checkout to any existing PYTHONPATH
    env = os.environ.copy()
    pkg_root = str(Path(__file__).resolve().parent.parent.parent)
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = pkg_root + (os.pathsep + existing if existing else "")
    serve_log = out / "serve.log"
    with open(serve_log, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "twotowermlretrieval_tpu_torch.serve.app",
             "--artifacts", str(serve_art), "--port", str(port),
             "--storage-dtype", "int8", "--batch-window-ms", "2", "--device", device],
            stdout=log_file, stderr=subprocess.STDOUT, env=env,
        )
    summary = {}
    try:
        deadline = time.time() + 600
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except (urllib.error.URLError, OSError):
                if proc.poll() is not None:
                    raise RuntimeError("server died: " + serve_log.read_text()[-2000:])
                time.sleep(1.0)
        else:
            raise TimeoutError("server did not become healthy")
        _log(lines, f"[4a] ttr-torch-serve up (int8 exact index, fused "
                    f"segment-max path, 2 ms micro-batch window) in "
                    f"{time.time() - t0:.0f}s")

        from twotowermlretrieval_tpu_torch.tools.loadtest import percentile, run_load

        rng = np.random.default_rng(7)
        queries = [
            " ".join(f"t{t}w{int(w)}"
                     for w in rng.integers(p["words_per_topic"], size=5))
            for t in rng.integers(p["num_topics"], size=32)
        ]
        url = f"http://127.0.0.1:{port}"
        run_load(url, queries, 8, 1, 0.7)  # warmup
        for conc in (1, 8):
            lats, server_ms, errors, wall = run_load(
                url, queries, p["loadtest_requests"], conc, 0.7,
                keep_alive=True)
            assert not errors, errors[:3]
            lats.sort()
            p50, p99 = percentile(lats, 50), percentile(lats, 99)
            rps = len(lats) / wall
            _log(lines, f"[4b] loadtest c={conc}: p50 {p50:.1f} ms, "
                        f"p99 {p99:.1f} ms, {rps:.1f} req/s "
                        f"({len(lats)} requests)")
            summary[f"p50_ms_c{conc}"] = round(p50, 1)
            summary[f"p99_ms_c{conc}"] = round(p99, 1)
            summary[f"req_per_s_c{conc}"] = round(rps, 1)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    launches["serve"] = _server_launches(serve_log)

    summary.update(
        scale=scale, corpus_docs=len(docs), vocab_rows=vocab_rows,
        recall10_random=round(float(base_recall), 4),
        recall10_trained=round(float(trained_recall), 4),
        examples_per_sec=round(float(steady), 0),
        total_seconds=round(time.time() - t_start, 0),
        device=_card(device), launches=launches,
    )
    _log(lines, "E2E_DEMO_RESULT " + json.dumps(summary))

    if log_path is not None:
        log_path.parent.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        log_path.write_text(
            f"# End-to-end demo run log, PyTorch/CUDA port ({scale} scale)\n\n"
            f"Produced by `ttr-torch-e2e-demo --scale {scale} --device {device}` on "
            f"{stamp} ({summary['device']}).\n\n"
            "```\n" + "\n".join(lines) + "\n```\n"
        )
        print(f"wrote {log_path}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "ttr_torch_e2e_demo"))
    ap.add_argument("--scale", default="full", choices=sorted(SCALES))
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="demo LR (the reference's 5e-5 also works; 1e-4 "
                         "converges in the demo's 2 epochs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--log", default=None,
                    help="write the run log to this markdown file")
    args = ap.parse_args(argv)
    run_demo(Path(args.out), args.scale, args.lr,
             Path(args.log) if args.log else None, args.device)


if __name__ == "__main__":
    main()
