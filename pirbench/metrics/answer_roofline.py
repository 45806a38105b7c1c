"""answer_roofline: the least time the servers' answers need on an H100
(``yardstick.answer_s``: bytes at the card's HBM bandwidth, the same work
whichever kernel the planner picked; the records a server's masks select
are counted as the configuration's scheme draws them, not from the masks)
over the device time of the kernels launched in the range around
``ShardedBackend.answer_batch``, for the batches answered in the traced
window."""


def read(ctx):
    device = ctx.trace.device_s("answer")
    seqs = [k for k, s in device.items() if s > 0 and k in ctx.answer_least]
    spent = sum(device[k] for k in seqs)
    if spent <= 0:
        return None
    return 100.0 * sum(ctx.answer_least[k] for k in seqs) / spent
