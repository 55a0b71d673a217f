"""The whole training step's share of the card's bf16 peak: the MLPs'
matrix operations a sample (forward, the weights' gradients and the
inputs' gradients where an input has one, from the layers' shapes) times
the configuration's target of samples a step, over the traced window."""

from benchmark import work


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("steps"):
        return None
    flops = (ctx["field"].train_flops() * int(ctx["cfg"]["target_batch_size"])
             * ctx["steps"])
    return 100.0 * flops / tr.window_s / work.BF16_FLOP_PER_S
