"""Verifier host stage: the C final exponentiation of the split verdict
per batch, from the verifier's ``stage_seconds["final_exp"]`` over its
host final exponentiations, in ms."""


def read(ctx):
    n = ctx.final_exps_delta
    secs = ctx.stage_delta.get("final_exp")
    return 1e3 * secs / n if n and secs is not None else None
