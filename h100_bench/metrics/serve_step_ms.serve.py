"""Host milliseconds per call of the serving callable, from the benchmark's
wrapper around the callable it hands ``InferenceServer``, over the calls
made after the profiler stopped."""


def read(ctx):
    calls = ctx.get("calls")
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in calls) / len(calls)
