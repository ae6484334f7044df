"""Forward, backward and recompute a step: CUDA events from the step's call
to the start of the optimizer's update, the window's total over its steps."""


def read(run):
    return run["model_ms"] / run["steps"] if run["steps"] else None
