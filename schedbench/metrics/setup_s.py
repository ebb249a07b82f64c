"""Seconds from the process's start to the window's opening: imports,
the card, the cluster and its init pods, the warm batches and the one
collection before the window."""


def read(ctx):
    return ctx.window.t_open - ctx.t_start
