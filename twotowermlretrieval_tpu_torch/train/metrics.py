"""Metric registry -> sinks (stdout JSONL, optional W&B).

The reference logs through two channels — W&B (init/watch/log,
ref: backend/main.py:228-234, 264-296) and emoji prints. Here metrics flow
through one logger with pluggable sinks: a JSONL file/stream (always, so
runs are machine-readable without external services) and W&B when the
package is importable and enabled (the environment may not have it).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional


def _jsonable(v):
    """Scalars -> float; arrays -> lists; anything else passes through
    (the sink must never kill the training loop over a metric value)."""
    if hasattr(v, "__float__"):
        try:
            return float(v)
        except (TypeError, ValueError):
            pass
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricLogger:
    def __init__(
        self,
        jsonl_path: Optional[str | Path] = None,
        stdout: bool = True,
        use_wandb: bool = False,
        wandb_project: str = "two-tower-retrieval-tpu",
        wandb_config: Optional[Dict[str, Any]] = None,
        run_name: Optional[str] = None,
    ):
        self.stdout = stdout
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self.run_name = run_name or f"run-{time.strftime('%Y%m%d_%H%M%S')}"
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                wandb.init(project=wandb_project, config=wandb_config, name=self.run_name)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 — wandb is best-effort
                print(f"wandb unavailable ({e}); falling back to JSONL only", file=sys.stderr)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: _jsonable(v) for k, v in metrics.items()})
        line = json.dumps(record)
        if self.stdout:
            print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(self._wandb_metrics(metrics), step=step)

    def _wandb_metrics(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """'<kind>_hist/<leaf>' bin-count vectors (paired with
        '<kind>_hist_max/<leaf>' symmetric range bounds, see
        train_step._add_param_histograms) become wandb.Histogram objects —
        the reference's wandb.watch gradient/parameter histograms
        (ref: backend/main.py:234). Everything else passes through."""
        import numpy as np

        out: Dict[str, Any] = {}
        for k, v in metrics.items():
            if "hist_max/" in k:
                continue  # folded into the paired Histogram below
            if "hist/" in k and hasattr(v, "__len__"):
                counts = np.asarray(v, dtype=np.float64)
                mx = float(metrics.get(k.replace("hist/", "hist_max/"), 0.0) or 1e-30)
                edges = np.linspace(-mx, mx, len(counts) + 1)
                try:
                    out[k] = self._wandb.Histogram(np_histogram=(counts, edges))
                except Exception:  # noqa: BLE001 — degrade to the raw counts
                    out[k] = counts.tolist()
            else:
                out[k] = v
        return out

    def finish(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None
