"""Circuits completed in the window over the window's seconds (host clock)."""


def read(run):
    return len(run.ends) / run.window_s
