"""Tokens of every step the window completed over the window's seconds
(host clock; the window is whole steps, each ending when its loss is read)."""


def read(run):
    return run.tokens / run.window_s if run.steps else None
