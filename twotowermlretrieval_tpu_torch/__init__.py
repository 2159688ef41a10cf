"""TwoTowerMLRetrieval, PyTorch/CUDA port of the JAX/TPU package.

Trains the two towers (``ttr-torch-train``) and serves hybrid dense +
TF-IDF search from an artifact directory (``ttr-torch-serve``) on an NVIDIA
Hopper card. The recurrent time loop (forward and backward) and the
segment-max top-k scan are CUDA C++ kernels under ``csrc/``, built with
nvcc at first use (``ops/_build.py``); everything around them is plain
PyTorch. The package imports neither ``jax`` nor the JAX package: the host
modules it needs (config, tokenizer, TF-IDF, telemetry, the triplet
loader, GloVe and synthetic-data helpers, the metric logger) are its own
copies.

Importing this package does not import torch, so a pickled TF-IDF
vectorizer written by the port unpickles anywhere numpy and scipy exist.
"""

__version__ = "0.1.0"

from twotowermlretrieval_tpu_torch.config import Config  # noqa: F401
