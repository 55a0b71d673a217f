"""The whole render's share of the card's bf16 peak: the MLPs' forward
operations a sample, from the layers' shapes, times every ray of every
view of the traced window times the inference budget of 256 samples a
ray (the program evaluates every slot), over the window."""

from benchmark import work

SAMPLES_PER_RAY = 256


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("views"):
        return None
    flops = (ctx["field"].mlp_flops() * ctx["rays_per_view"] * ctx["views"]
             * SAMPLES_PER_RAY)
    return 100.0 * flops / tr.window_s / work.BF16_FLOP_PER_S
