"""The training step's share of the card's bf16 peak: the model operations
of the window's steps (``yardstick.train_step_flops`` from each step's
batch rows and bucket widths: both towers' products and the in-batch
logits, times 3 for the backward) over the window's wall time (the
untraced window of a traced run, on the host clock), over 989 TFLOP/s a card.
It names no kernel, so a step whose kernels change keeps this measure.
A data-parallel cell counts its global batch over all its cards' peak."""

from benchmarks.harness.yardstick import PEAK_BF16_FLOPS, train_step_flops

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "Train step", "train_examples_per_s"


def read(ctx):
    w = ctx.window
    if not w or not w["steps"]:
        return None
    flops = sum(train_step_flops(ctx.model, B, Tq, Td) for B, Tq, Td in w["steps"])
    return 100.0 * flops / w["wall_s"] / (PEAK_BF16_FLOPS * ctx.chips)
