"""Host time to enqueue a training step: the benchmark's host clock around
its calls of the step over each group, summed over the window, divided by
the window's steps (the untraced window of a traced run)."""

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "Training driver", "train_examples_per_s"


def read(ctx):
    w = ctx.window
    if not w or not w["steps"]:
        return None
    return 1e3 * w["dispatch_s"] / len(w["steps"])
