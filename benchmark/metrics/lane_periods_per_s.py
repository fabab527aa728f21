"""Lane-periods completed per second: B × the closed-loop periods completed
in the window ÷ the window's seconds (host clock, all the work over all
the time)."""


def read(ctx):
    return ctx["B"] * ctx["n_window"] / ctx["window_s"]
