"""The plain reference: the two towers, the in-batch loss, the clip and
Adam in plain PyTorch, float32 products with TF32 off. It imports nothing
of the program (``twotowermlretrieval_tpu_torch``) nor JAX; it is given
the benchmark's seed-made weights and rows and works out everything else
itself, the dropout masks included (``train.py``)."""
