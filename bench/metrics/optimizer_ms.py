"""The optimizer's update a step: CUDA events around the update of the
optimizer handed to the step, the window's total over its steps."""


def read(run):
    return run["optimizer_ms"] / run["steps"] if run["steps"] else None
