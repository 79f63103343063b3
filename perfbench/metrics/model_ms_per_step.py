"""Device ms a step outside the optimizer: the forward and backward of
``lm_loss``, every op launched outside the ``adamw_update`` range and
outside the ranges ``perfbench/train.py`` puts around the batch's copy to
the card (``perfbench.batch``) and the loss's read (``perfbench.sync``)."""
WRAPS = (("repro_torch.runtime.executor", "adamw_update"),)
BACKWARD_NODES = ()


def read(trace):
    if not trace.steps:
        return None
    return 1e3 * trace.seconds_outside("perfbench.adamw_update",
                                       "perfbench.batch",
                                       "perfbench.sync") / trace.steps
