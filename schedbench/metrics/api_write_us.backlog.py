"""Mean host microseconds of one create or delete the generator made in
the window (the benchmark's own clock around each call)."""


def read(ctx):
    calls = ctx.api_calls
    return 1e6 * sum(calls) / len(calls) if calls else None
