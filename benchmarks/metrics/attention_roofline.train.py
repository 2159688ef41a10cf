"""The fused attention kernels' share of their roofline in training: the
least time of every attention call of the traced steps, forward and
backward (``yardstick.attention_bound`` over B x heads rows at each
tower's width, inputs in the residual dtype), over the device time of the
launches named ``attention_fwd_*`` and ``attention_bwd_*``."""

from benchmarks.harness.readers import dtype_bytes, per_tower_widths, roofline_share
from benchmarks.harness.yardstick import attention_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Attention kernels", "train_examples_per_s"
PATTERN = r"\battention_(fwd|bwd)_"


def _calls(ctx):
    m = ctx.model
    nh, H = int(m["NUM_HEADS"]), int(m["HIDDEN_DIM"])
    in_bytes = dtype_bytes(m, "RESIDUAL_DTYPE", "float32")
    cdt = str(m.get("COMPUTE_DTYPE", "bfloat16"))
    for B, T in per_tower_widths(ctx.traced_steps):
        for _ in range(int(m["NUM_LAYERS"])):
            for backward in (False, True):
                yield attention_bound(B // ctx.ranks * nh, T, H // nh, in_bytes, backward, cdt)


def read(ctx):
    return roofline_share(ctx.trace, PATTERN, _calls(ctx))
