"""Seconds from the start of the process to the start of the window:
imports, the port's kernel build or load, the controllers, the fleet,
the world and the warm-up periods."""


def read(ctx):
    return ctx["setup_s"]
