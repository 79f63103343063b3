"""Device ms a step of the ops launched inside the executor's call of
``adamw_update`` (``optim/adamw.py``)."""
WRAPS = (("repro_torch.runtime.executor", "adamw_update"),)
BACKWARD_NODES = ()


def read(trace):
    if not trace.calls.get("adamw_update"):
        return None
    return 1e3 * trace.seconds_in("perfbench.adamw_update") / trace.steps
