"""TwoTowerMLRetrieval, PyTorch/CUDA port of the JAX/TPU package.

Trains the two towers (``ttr-torch-train``) and serves hybrid dense +
TF-IDF search from an artifact directory (``ttr-torch-serve``, over a
bf16, f32 or int8 corpus index) on an NVIDIA Hopper card. The recurrent
time loop (forward and backward), the segment-max top-k scans (bf16/f32,
per-row int8, per-segment s8) and the running top-k are CUDA C++ kernels
under ``csrc/``, built with nvcc at first use (``ops/_build.py``);
everything around them is plain PyTorch. The package imports neither ``jax`` nor the JAX package: the host
modules it needs (config, tokenizer, TF-IDF, telemetry, the triplet
loader, GloVe and synthetic-data helpers, the metric logger) are its own
copies.

Importing this package does not import torch, so a pickled TF-IDF
vectorizer written by the port unpickles anywhere numpy and scipy exist.
"""

__version__ = "0.1.0"

from twotowermlretrieval_tpu_torch.config import Config  # noqa: F401
