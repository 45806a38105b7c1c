"""plan_device_ms: device milliseconds a batch of the kernels launched
while the pipeline planned it (the range around ``plan_requests``: the
router, the scheme's query generation and the execution planner), over
the batches planned in the traced window."""


def read(ctx):
    per_batch = ctx.trace.device_s("plan")
    if not per_batch or not ctx.trace.ops:
        return None
    return 1e3 * sum(per_batch.values()) / len(per_batch)
