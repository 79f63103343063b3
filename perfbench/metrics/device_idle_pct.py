"""Share of the traced steps' span in which no kernel, copy or set runs on
the card."""
WRAPS = ()
BACKWARD_NODES = ()


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
