"""End-to-end training driver, behind ``ttr-torch-train``: the port of the
JAX package's ``train/loop.py``.

Pipeline: tokenizer + GloVe table -> triplet datasets -> train steps ->
per-epoch batch and corpus evaluation -> artifact export -> qualitative
test eval. What it keeps from the JAX driver:

- the per-epoch shuffle seed ``config.seed + 1000 + epoch``;
- the per-width buffered grouping of ``STEPS_PER_DISPATCH`` batches
  (:func:`packed_groups`). It fixes the order in which batches run and
  what a resume skips; here the K steps of a group run as a plain loop,
  one packed host-to-device copy per group;
- metrics stay on the device and are fetched at log boundaries and at the
  end of an epoch; throughput counts real (not repeat-padded) rows;
- checkpoints with the data position, and a deterministic resume;
- the eval-only ``--model_path`` mode (test evaluation only, no training,
  no export);
- export through ``train/artifacts.py``.

It runs on ``cuda`` unless the caller asks for ``--device cpu`` (the
kernels' plain versions). Parameters are initialized from a CPU generator
seeded with ``config.seed`` and the dropout stream is a generator on the
device seeded with ``config.seed + 1``; the numbers differ from the JAX
package's for the same seed.

:func:`train` reads the datasets from parquet; :func:`train_on_datasets`
is the part after that and takes the datasets as a dict of triplet lists.
Both tower types train (the recurrent and the transformer tower).
``--profile_dir`` traces about 10 steady steps from step 10 with
``torch.profiler`` (``utils/profiling.py``), as the JAX driver's window
does.

Data parallel: ``main`` starts the ``torch.distributed`` world from
torchrun's variables (``parallel/mesh.py:initialize_multihost``; a lone
process stays a world of one), so ``torchrun --nproc-per-node N -m
twotowermlretrieval_tpu_torch.train.loop --config <json>`` trains over N
ranks, one a card (``cuda:LOCAL_RANK``). ``MESH_DATA`` ranks (-1: the
whole world) split each global batch (``BATCH_SIZE`` must divide by
them); every rank builds the same batches and the same replicated state
and runs the data-parallel step on its rows (``parallel/distributed.py``),
and batch, corpus and test evaluation run through the mesh. The metric
sinks, the export and the test printout are rank 0's; checkpoints are
written by rank 0 and restored by every rank; throughput counts the
global batch's real rows. A 1x1 mesh is the single-device path.

The model axis: ``MESH_MODEL`` M > 1 ranks a model group (the world is
``MESH_DATA`` x M ranks; rank r at data index r // M). The transformer
tower splits its heads and FFN columns over the group, and with
``SHARD_EMBEDDING_TABLE`` each tower's table is split into M row blocks
(``parallel/distributed.py``); every rank builds the whole init and keeps
its shard. A recurrent tower with no sharded table runs replicated over
the group, as in JAX. Without a model group ``SHARD_EMBEDDING_TABLE`` is
dropped (a table in one block is the whole table). Checkpoints gather the
shards into the one-process format and each rank restores its own; the
export gathers the params over the group once and rank 0 writes the
single-device artifact. Evaluation, the export's encoder and the
eval-only mode encode through specs with no model axis where they run on
one rank's whole params.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, pack_batch, unpack_batch
from twotowermlretrieval_tpu_torch.data.glove import load_embedding_table
from twotowermlretrieval_tpu_torch.data.loader import TripletBuilder
from twotowermlretrieval_tpu_torch.encoder import TextEncoder
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower, to_device
from twotowermlretrieval_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_multihost,
    mesh_shape,
    put_global,
    rank_device,
    resolve_mesh,
)
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
from twotowermlretrieval_tpu_torch.train.artifacts import save_inference_artifacts
from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
from twotowermlretrieval_tpu_torch.train.evaluators import (
    BatchEvaluator,
    CorpusEvaluator,
    TestEvaluator,
)
from twotowermlretrieval_tpu_torch.train.metrics import MetricLogger
from twotowermlretrieval_tpu_torch.train.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    merge_params,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device
from twotowermlretrieval_tpu_torch.utils.profiling import annotate, trace

# The data-position tag saved with checkpoints: it names the group yield
# order of packed_groups (per-width buffering), the JAX driver's. A resume
# from a checkpoint with another tag restarts its epoch instead of
# skipping a different batch prefix.
_DATA_GROUPING = "per-width-v1"


def setup(config: Config):
    """Tokenizer + embedding table + the runtime-derived config keys."""
    tokenizer = Tokenizer.from_pickle(config.word_to_idx_path)
    table = load_embedding_table(config.embeddings_path, tokenizer.vocab_size(), seed=config.seed)
    config = config.replace(vocab_size=tokenizer.vocab_size(), embed_dim=table.shape[1])
    return config, tokenizer, table


def _check_supported(config: Config) -> None:
    data, _ = mesh_shape(config.mesh_data, config.mesh_model)  # raises past the world
    if config.batch_size % data:
        raise ValueError(
            f"BATCH_SIZE={config.batch_size} must be divisible by the "
            f"data mesh axis ({data})"
        )


def build_mesh(config: Config) -> Optional[Mesh]:
    """The ('data', 'model') mesh of ``MESH_DATA`` x ``MESH_MODEL`` ranks,
    or ``None`` for the single-device path (1x1). Every rank calls it."""
    _check_supported(config)
    return resolve_mesh(config.mesh_data, config.mesh_model)


def packed_groups(batches, K: int) -> Iterator[Tuple[np.ndarray, int]]:
    """Stack K same-shape packed buffers into ([k, B, W] array,
    real-example count) pairs, buffering per width as the JAX driver does,
    so the yield order (and so the order of the steps) is the same. The
    count excludes repeat-padded rows. A group's host work (drawing and
    packing its batches, the stack) is one ``ttr.data.pack`` span, closed
    before the group is handed on; one more finds the stream's end."""
    pending: Dict[tuple, list] = {}

    def flush(buf):
        stack = np.stack(buf)
        return stack, int(stack[:, :, -1].sum())  # last column = example_mask

    batches = iter(batches)
    while True:
        with annotate("ttr.data.pack"):
            group = None
            for b in batches:
                p = pack_batch(b)
                buf = pending.setdefault(p.shape, [])
                buf.append(p)
                if len(buf) == K:
                    group = flush(buf)
                    pending[p.shape] = []
                    break
        if group is None:
            break
        yield group
    for buf in pending.values():
        if buf:
            with annotate("ttr.data.pack"):
                group = flush(buf)
            yield group


def _skip_group_batches(groups, n: int):
    skipped = 0
    for stack, n_real in groups:
        if skipped < n:
            skipped += stack.shape[0]
            continue
        yield stack, n_real


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Metric tensors to host values: scalars as floats, histograms as
    numpy vectors."""
    out = {}
    for k, v in metrics.items():
        v = v.detach().cpu()
        out[k] = float(v) if v.numel() == 1 else v.numpy()
    return out


def _scalars(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop histogram vectors and their range bounds from the epoch-mean
    accumulator."""
    return {k: v for k, v in m.items() if "hist/" not in k and "hist_max/" not in k}


def train(
    config: Config,
    use_wandb: bool = False,
    output_root: str | Path = "artifacts",
    checkpoint_dir: Optional[str | Path] = None,
    resume: bool = False,
    model_path: Optional[str | Path] = None,
    run_name: Optional[str] = None,
    profile_dir: Optional[str | Path] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Train (or, with ``model_path``, only test-evaluate) from the
    config's parquet splits; see :func:`train_on_datasets`."""
    _check_supported(config)
    resolve_device(device)
    config, tokenizer, table = setup(config)
    datasets = TripletBuilder(config).load_datasets(subsample_ratio=config.subsample_ratio)
    return train_on_datasets(
        config, tokenizer, table, datasets, use_wandb=use_wandb, output_root=output_root,
        checkpoint_dir=checkpoint_dir, resume=resume, model_path=model_path,
        run_name=run_name, profile_dir=profile_dir, device=device,
    )


def train_on_datasets(
    config: Config,
    tokenizer: Tokenizer,
    table: np.ndarray,
    datasets: Dict[str, Any],
    *,
    use_wandb: bool = False,
    output_root: str | Path = "artifacts",
    checkpoint_dir: Optional[str | Path] = None,
    resume: bool = False,
    model_path: Optional[str | Path] = None,
    run_name: Optional[str] = None,
    profile_dir: Optional[str | Path] = None,
    device="cuda",
) -> Dict[str, Any]:
    """The driver after the datasets are loaded: ``datasets`` maps 'train',
    'validation' and 'test' to lists of (query, positive, negative)
    triplets; ``config`` and ``table`` come from :func:`setup`.
    ``profile_dir``: write a trace there of the steps from the first group
    that starts at step 10 or later (after the first group) until 10 more
    steps are done; a run that ends inside the window finalizes it.
    ``profile_window`` in the results then says where it started and
    stopped and whether it filled.

    Returns the JAX driver's results (run name, throughput, per-epoch
    metrics, artifacts directory, test eval) plus ``steps``,
    ``step_losses`` (every step's loss, fetched once per epoch),
    ``steady_steps_per_sec`` and the final ``state``. Under a mesh every
    rank returns them but for the artifacts directory and the test eval,
    which are rank 0's."""
    mesh = build_mesh(config)
    dev = resolve_device(device)
    if mesh is not None:
        dev = rank_device(dev)
    if config.shard_embedding_table and (mesh is None or mesh.model_group is None):
        config = config.replace(shard_embedding_table=False)  # no 'model' axis to split over
    lead = mesh is None or mesh.is_lead
    if config.log_param_stats is None:
        config = config.replace(log_param_stats=use_wandb)
    if config.log_param_histograms is None:
        config = config.replace(log_param_histograms=use_wandb)
    spec = TwoTowerSpec.from_config(config)
    # encoding on one rank's whole params (the export, the eval-only mode):
    # no sharded lookup, no tensor-parallel sums
    host_spec = TwoTowerSpec.from_config(config.replace(shard_embedding_table=False,
                                                        mesh_model=1))
    rules = None

    def encoder_for(params):
        return TextEncoder(params, host_spec, tokenizer, batch_size=config.batch_size,
                           max_query_len=config.max_query_len,
                           max_doc_len=config.max_doc_len, device=dev)

    if model_path is not None:
        # eval-only mode: the saved weights, the test evaluator, nothing else
        from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz

        logger = MetricLogger(use_wandb=use_wandb and lead, stdout=lead,
                              wandb_config=config.to_dict(), run_name=run_name)
        results = {
            "run_name": logger.run_name,
            "test_eval": TestEvaluator(seed=config.seed).evaluate(
                encoder_for(load_params_npz(model_path)), datasets.get("test", [])
            ),
        }
        logger.finish()
        return results

    params = init_two_tower(torch.Generator().manual_seed(config.seed), spec,
                            pretrained_embeddings=table)
    generator = torch.Generator(device=dev).manual_seed(config.seed + 1)
    state = create_train_state(generator, to_device(params, dev), config)
    del params
    if mesh is not None:
        from twotowermlretrieval_tpu_torch.parallel.distributed import (
            MeshTextEncoder,
            gather_params,
            make_sharded_packed_eval_step,
            make_sharded_packed_train_step,
            replicate_state,
            rules_for,
        )

        rules = rules_for(config, mesh)
        state = replicate_state(state, mesh, rules)

    # only rank 0 owns the sinks: N ranks would print (and log to W&B) N-fold
    logger = MetricLogger(use_wandb=use_wandb and lead, stdout=lead,
                          wandb_config=config.to_dict(), run_name=run_name)
    results: Dict[str, Any] = {"run_name": logger.run_name}

    def build_step(step_config):
        """(state, packed [B(_local), W] rows on the device) -> (state, metrics)."""
        if mesh is not None:
            return make_sharded_packed_train_step(spec, step_config, mesh,
                                                  step_config.max_query_len)
        raw_step = make_train_step(spec, step_config)
        return lambda st, packed: raw_step(st, unpack_batch(packed, step_config.max_query_len))

    if mesh is not None:
        eval_step = make_sharded_packed_eval_step(spec, config, mesh, config.max_query_len)
        mesh_encoder = MeshTextEncoder(state, spec, tokenizer, mesh, dev,
                                       batch_size=config.batch_size,
                                       max_query_len=config.max_query_len,
                                       max_doc_len=config.max_doc_len)
    else:
        raw_eval = make_eval_step(spec, config)

        def eval_step(st, packed):
            return raw_eval(st, unpack_batch(packed, config.max_query_len))

    batch_evaluator = BatchEvaluator()
    corpus_evaluator = CorpusEvaluator(seed=config.seed)
    train_batcher = TripletBatcher(
        datasets["train"], tokenizer, config.batch_size, config.max_query_len,
        config.max_doc_len, length_buckets=config.length_buckets,
    )
    val_batcher = TripletBatcher(
        datasets["validation"], tokenizer, config.batch_size, config.max_query_len,
        config.max_doc_len, length_buckets=config.length_buckets,
    )
    K = max(1, int(config.steps_per_dispatch))
    # Histograms bucket every grad/param element; they are computed only in
    # groups that cross a log boundary, as in the JAX driver.
    train_step = build_step(config.replace(log_param_histograms=False))
    train_step_hist = build_step(config) if config.log_param_histograms else train_step

    ckpt = CheckpointManager(checkpoint_dir, mesh=mesh, rules=rules) if checkpoint_dir else None
    start_epoch, skip_batches = 0, 0
    if resume and ckpt and ckpt.latest_step() is not None:
        state, position = ckpt.restore(state)
        start_epoch = position.get("epoch", 0)
        skip_batches = position.get("batch_index", 0)
        if skip_batches and position.get("grouping") != _DATA_GROUPING:
            print(f"checkpoint data-grouping {position.get('grouping')!r} != "
                  f"{_DATA_GROUPING!r}; restarting epoch {start_epoch} from batch 0")
            skip_batches = 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_start = time.time()
    examples_seen = 0
    epoch_metrics_history = []
    step_losses = []
    step = state.step
    first_group_done = False
    profile_ctx = profile_window = None
    compile_seconds = None
    steady_baseline = steady_steps_baseline = 0
    steps_run = 0
    train_elapsed = steady_elapsed = 0.0
    for epoch in range(start_epoch, config.epochs):
        epoch_seed = config.seed + 1000 + epoch  # deterministic shuffle per epoch
        running = None
        num_batches = 0
        epoch_losses = []
        t_epoch = time.time()
        t_epoch_steady = t_epoch if first_group_done else None
        groups = packed_groups(train_batcher.batches(seed=epoch_seed), K)
        batch_index = 0
        if epoch == start_epoch and skip_batches:
            # replay the shuffle and the buffered grouping, then drop the
            # done groups; checkpoints land on group boundaries
            groups = _skip_group_batches(groups, skip_batches)
            batch_index = skip_batches
        for stack, n_real in groups:
            k = stack.shape[0]
            if profile_dir is not None and profile_ctx is None and first_group_done \
                    and step >= 10:
                # about 10 steady steps, past the first group's build and launches
                profile_ctx = trace(str(profile_dir))
                profile_ctx.__enter__()
                profile_window = {"start_step": step}
            t_group0 = None if first_group_done else time.time()
            crosses_log = step // config.log_every_steps != (step + k) // config.log_every_steps
            fn = train_step_hist if crosses_log else train_step
            packed = put_global(stack, mesh, dev, axis=1)  # this rank's rows of each batch
            for i in range(k):
                state, metrics = fn(state, packed[i])
                epoch_losses.append(metrics["loss"])
                scalars = _scalars(metrics)
                running = (dict(scalars) if running is None
                           else {n: running[n] + v for n, v in scalars.items()})
            prev_step = step
            step += k
            steps_run += k
            batch_index += k
            num_batches += k
            examples_seen += n_real
            if t_group0 is not None:
                # the first group pays the kernels' build and first launches;
                # steady throughput is counted after it
                sync()
                compile_seconds = time.time() - t_group0
                t_epoch_steady = time.time()
                steady_baseline, steady_steps_baseline = examples_seen, steps_run
                first_group_done = True
            if profile_ctx is not None and step >= profile_window["start_step"] + 10:
                sync()
                profile_ctx.__exit__(None, None, None)
                profile_ctx = profile_dir = None
                profile_window.update(stop_step=step, filled=True)
            if step // config.log_every_steps != prev_step // config.log_every_steps:
                host_metrics = _fetch(metrics)
                loop_time = train_elapsed + (time.time() - t_epoch)
                host_metrics["examples_per_sec"] = examples_seen / max(loop_time, 1e-9)
                logger.log({"epoch": epoch + 1,
                            **{f"train_{n}": v for n, v in host_metrics.items()}}, step)
            if ckpt and (step // config.checkpoint_every_steps
                         != prev_step // config.checkpoint_every_steps):
                ckpt.save(state, {"epoch": epoch, "batch_index": batch_index,
                                  "grouping": _DATA_GROUPING})

        if epoch_losses:
            step_losses.extend(torch.stack(epoch_losses).cpu().tolist())  # synchronizes
        sync()
        now = time.time()
        train_elapsed += now - t_epoch
        if t_epoch_steady is not None:
            steady_elapsed += now - t_epoch_steady
        avg_train = ({n: v / max(num_batches, 1) for n, v in _fetch(running).items()}
                     if running is not None else {})

        batch_metrics, avg_val_loss = batch_evaluator.evaluate(
            eval_step, state, val_batcher, dev, mesh
        )
        corpus_metrics = corpus_evaluator.evaluate(
            mesh_encoder if mesh is not None
            else encoder_for(merge_params(state.trainable, state.frozen)),
            datasets["validation"],
        )
        log_data = {"epoch": epoch + 1, "avg_train_loss": avg_train.get("loss", 0.0),
                    "avg_val_loss": avg_val_loss}
        log_data.update({f"batch_{n}": v for n, v in batch_metrics.items()})
        log_data.update({f"corpus_{n}": v for n, v in corpus_metrics.items()})
        logger.log(log_data, step)
        epoch_metrics_history.append(log_data)
        if ckpt:
            ckpt.save(state, {"epoch": epoch + 1, "batch_index": 0, "grouping": _DATA_GROUPING})

    if profile_ctx is not None:
        # the run ended inside the window: finalize it so the trace is written
        profile_ctx.__exit__(None, None, None)
        profile_ctx = None
        profile_window.update(stop_step=step, filled=False)

    results["train_seconds"] = time.time() - t_start  # wall, evals included
    results["train_loop_seconds"] = train_elapsed
    results["examples_per_sec"] = examples_seen / max(train_elapsed, 1e-9)
    results["steps"] = steps_run
    results["step_losses"] = step_losses
    if first_group_done:
        results["compile_seconds"] = compile_seconds
        results["steady_examples_per_sec"] = (
            (examples_seen - steady_baseline) / max(steady_elapsed, 1e-9)
        )
        results["steady_steps_per_sec"] = (
            (steps_run - steady_steps_baseline) / max(steady_elapsed, 1e-9)
        )
    results["epochs"] = epoch_metrics_history
    results["state"] = state
    if profile_window is not None:
        results["profile_window"] = profile_window

    final_params = merge_params(state.trainable, state.frozen)
    if mesh is not None:  # every rank takes part in the gather, once
        final_params = gather_params(final_params, rules, mesh.model_group)
    if lead:  # file writes and the printout are rank 0's
        output_dir = Path(output_root) / logger.run_name
        export_encoder = encoder_for(final_params)
        save_inference_artifacts(output_dir, final_params, config, tokenizer, datasets,
                                 encoder=export_encoder)
        results["artifacts_dir"] = str(output_dir)
        if datasets.get("test"):
            results["test_eval"] = TestEvaluator(seed=config.seed).evaluate(
                export_encoder, datasets["test"]
            )
    if mesh is not None:
        dist.barrier()  # no rank leaves before the export is written
    logger.finish()
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Two-tower training & evaluation (PyTorch/CUDA)")
    parser.add_argument("--config", "-c", type=str, required=True, help="JSON config path")
    parser.add_argument("--model_path", "-m", type=str, default=None,
                        help="saved model (.npz) for eval-only mode, skipping training")
    parser.add_argument("--wandb", action="store_true", help="log to W&B if available")
    parser.add_argument("--output", type=str, default="artifacts")
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome/Kineto JSON) of "
                             "about 10 steps from step 10 here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = Config.from_json(args.config)
    initialize_multihost(device=args.device)  # torchrun's world, if it started one
    try:
        results = train(
            config,
            use_wandb=args.wandb,
            output_root=args.output,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            model_path=args.model_path,
            profile_dir=args.profile_dir,
            device=args.device,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if "examples_per_sec" in results:
        print(f"training finished: {results['examples_per_sec']:.1f} examples/s")
    if "steady_examples_per_sec" in results:  # past the first group's build and launches
        print(f"steady: {results['steady_examples_per_sec']:.1f} examples/s, "
              f"{results['steady_steps_per_sec']:.3f} steps/s")
    if "artifacts_dir" in results:
        print(f"artifacts: {results['artifacts_dir']}")


if __name__ == "__main__":
    main()
