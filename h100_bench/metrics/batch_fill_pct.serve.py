"""Requests served per slot the server computed, over the whole window:
served / (calls x batch), in %."""


def read(ctx):
    calls = ctx.get("all_calls")
    if not calls:
        return None
    return 100.0 * ctx["served"] / (calls * ctx["batch"])
