"""Samples a training step keeps: the march's demand that the program
counts in each refresh window (``measured_batch_size``) over the window's
steps, clipped at what a step can hold (the compaction cap, else the
batch's [rays, samples] slots), averaged over the traced windows."""


def read(ctx):
    demand = ctx.get("demand")
    if not demand:
        return None
    rays, per_ray = ctx["shape"]
    cap = ctx["cfg"].get("compacted_batch") or rays * per_ray
    n = ctx["steps_per_window"]
    return sum(min(d / n, cap) for d in demand) / len(demand)
