"""The driver of training cells: the port's train step over packed groups.

What ``train/loop.py`` does between its batches is what runs here: the
batches of a ``triplets`` mix go through ``packed_groups`` (K =
``STEPS_PER_DISPATCH`` same-width batches packed on the host), each group
is copied to the device in one piece (``put_global``) and its K steps run
through the step ``make_train_step`` builds, each on ``unpack_batch``'s
views. The loop's logging, evaluation and checkpoints are not run.

Set-up makes the weights and the rows from the seed, builds the state and
the step, and runs the first group: its first three steps are the ones the
reference follows (Adam's first moment after step 1, the leaves' change
after step 3). It then runs groups until every doc width of the pool has
run, and synchronizes. The window runs whole groups until ``seconds`` have
passed and ends at a synchronize. A traced run then traces
``trace_groups`` more groups. After the window the memory peak is read,
the program's state is freed, and the reference runs the first three steps
again from the same weights and rows.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmarks.harness import checks
from benchmarks.harness.seeds import sub_seed
from benchmarks.harness.trace import span
from benchmarks.harness.traffic import TripletPool
from benchmarks.harness.weights import make_params

CHECKED_STEPS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrainRun:
    def __init__(self, model: dict, mix: dict, seed: int, device):
        from twotowermlretrieval_tpu_torch.config import Config
        from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
        from twotowermlretrieval_tpu_torch.train.train_step import (
            create_train_state,
            make_train_step,
        )

        self.model, self.seed, self.dev = model, seed, torch.device(device)
        self.config = Config.from_dict(model)
        spec = TwoTowerSpec.from_config(self.config)
        params = make_params(model, seed, self.dev)
        dropout = torch.Generator(device=self.dev).manual_seed(sub_seed(seed, "dropout"))
        self.state = create_train_state(dropout, params, self.config)
        del params
        self.step = make_train_step(spec, self.config)
        self.pool = TripletPool(mix, model, seed, self.dev)
        self.K = max(1, int(self.config.steps_per_dispatch))
        self.losses: List[torch.Tensor] = []
        self.first: Optional[dict] = None
        self.mesh = None  # a data-parallel run's mesh (harness/train_dp_driver.py)

    def _groups(self):
        """``packed_groups`` over the pool's stream; the stream's first
        batches are kept, so the reference gets the rows themselves."""
        from twotowermlretrieval_tpu_torch.train.loop import packed_groups

        self.made = []

        def recorded():
            for b in self.pool.batches():
                if self.first is None and len(self.made) < 4 * self.K * len(self.pool.edges):
                    self.made.append(b)
                yield b

        return packed_groups(recorded(), self.K)

    def _leaves(self, tree) -> Dict[str, torch.Tensor]:
        from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

        return dict(named_leaves(tree))

    def _run_group(self, stack, on_step=None):
        """One group: copy, then its K steps. Returns the host seconds spent
        enqueuing the steps."""
        from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
        from twotowermlretrieval_tpu_torch.parallel.mesh import put_global

        Lq = self.config.max_query_len
        with span("bench.copy"):
            packed = put_global(stack, self.mesh, self.dev, axis=1)
        t0 = time.perf_counter()
        with span("bench.dispatch"):
            for i in range(stack.shape[0]):
                self.state, metrics = self.step(self.state, unpack_batch(packed[i], Lq))
                self.losses.append(metrics["loss"])
                if on_step is not None:
                    on_step(i + 1, metrics)
        return time.perf_counter() - t0

    def _shape(self, stack):
        Lq = self.config.max_query_len
        return (stack.shape[1], Lq, (stack.shape[2] - Lq - 4) // 2)

    def setup(self):
        """The first group (the checked steps), then a group of every other
        doc width of the pool; ends synchronized."""
        start = {n: p.detach().clone() for n, p in self._leaves(self.state.trainable).items()}
        first: dict = {"loss": []}

        def on_step(i, metrics):
            if i <= CHECKED_STEPS:
                first["loss"].append(metrics["loss"])
            if i == 1:  # Adam's first moment is (1 - b1) times the clipped gradient
                mu = self._leaves(self.state.opt_state["mu"])
                first["grad_norms"] = {n: torch.linalg.vector_norm(m) / 0.1
                                       for n, m in mu.items()}
            if i == CHECKED_STEPS:
                now = self._leaves(self.state.trainable)
                first["change_rows"] = {n: checks.row_norms(now[n].detach() - s)
                                        for n, s in start.items()}

        self.groups = self._groups()
        with span("bench.pack"):
            stack, _ = next(self.groups)
        if stack.shape[0] < CHECKED_STEPS:
            raise ValueError(f"a group of {stack.shape[0]} steps; the check needs "
                             f"{CHECKED_STEPS}")
        width = self._shape(stack)[2]
        self.checked_batches = [b for b in self.made
                                if b.pos_tokens.shape[1] == width][:CHECKED_STEPS]
        self._run_group(stack, on_step)
        del start
        seen = {self._shape(stack)[2]}
        want = set(self.pool.widths())
        while not want <= seen:
            with span("bench.pack"):
                stack, _ = next(self.groups)
            self._run_group(stack)
            seen.add(self._shape(stack)[2])
        _sync(self.dev)
        self.first = {
            "loss": [float(x) for x in first["loss"]],
            "grad_norms": {n: float(v) for n, v in first["grad_norms"].items()},
            "change_rows": {n: v.double().cpu().numpy() for n, v in first["change_rows"].items()},
        }
        self.losses, self.made = [], []

    def window(self, seconds: float) -> dict:
        """Whole groups until ``seconds`` have passed, then a synchronize."""
        steps: List[tuple] = []
        examples, dispatch = 0, 0.0
        t0 = time.perf_counter()
        while True:
            with span("bench.pack"):
                stack, n_real = next(self.groups)
            dispatch += self._run_group(stack)
            steps += [self._shape(stack)] * stack.shape[0]
            examples += n_real
            if self.stop(time.perf_counter() - t0 >= seconds):
                break
        with span("bench.sync"):
            _sync(self.dev)
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "steps": steps, "examples": examples, "dispatch_s": dispatch}

    def stop(self, elapsed: bool) -> bool:
        """Whether the window ends after this group (a data-parallel run
        takes its first rank's answer on every rank)."""
        return elapsed

    def traced(self, groups: int, trace_path: str) -> List[tuple]:
        """``groups`` more groups under ``torch.profiler``; the trace is
        written to ``trace_path``."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        steps: List[tuple] = []
        _sync(self.dev)
        with profile(activities=acts) as prof:
            for _ in range(groups):
                with span("bench.pack"):
                    stack, _ = next(self.groups)
                self._run_group(stack)
                steps += [self._shape(stack)] * stack.shape[0]
            with span("bench.sync"):
                _sync(self.dev)
        prof.export_chrome_trace(trace_path)
        return steps

    def finite_losses(self) -> tuple:
        """(steps run since set-up, steps whose loss is not finite)."""
        if not self.losses:
            return 0, 0
        ls = torch.stack(self.losses).float()
        return len(self.losses), int((~torch.isfinite(ls)).sum())

    def free(self):
        """Drop the program's state before the reference runs."""
        self.state = self.step = self.groups = None
        self.losses = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, **kw) -> Dict[str, float]:
        """The program's readings of the checked steps against the
        reference's (``kw``: ``reference/train.py`` ``readings``' options):
        ``checks.training_gaps``."""
        return checks.training_gaps(self.first, self.reference(**kw))

    def reference(self, precision: str = "float32", half_batch: bool = False, **kw) -> dict:
        from benchmarks.reference.train import readings

        batches = []
        for b in self.checked_batches:
            t = {k: torch.as_tensor(getattr(b, k), device=self.dev) for k in b._fields}
            batches.append({"q_tokens": t["q_tokens"], "q_len": t["q_len"],
                            "d_tokens": t["pos_tokens"], "d_len": t["pos_len"],
                            "weights": t["example_mask"]})
        params = make_params(self.model, self.seed, self.dev)
        return readings(params, batches, self.model, sub_seed(self.seed, "dropout"), self.dev,
                        precision=precision, half_batch=half_batch, **kw)


def run_cell(cell: dict, model: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, tmpdir: str) -> dict:
    """One run of a training cell; see the module docstring. ``t_start``:
    the process's start on ``time.perf_counter``'s clock."""
    import os

    run = TrainRun(model, mix, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    out = {
        "e2e": {"train_examples_per_s": win["examples"] / win["wall_s"], "setup_s": setup_s},
        "window": win,
        "model": model,
    }
    if trace:
        path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
        out["traced_steps"] = run.traced(int(cell.get("trace_groups", 2)), path)
        out["trace_path"] = path
    out["attempted"], out["failed"] = run.finite_losses()
    dev = torch.device(device)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else 0)
    run.free()
    out["numbers"] = run.check()
    return out
