"""Verifier host stage: the pack's host time per set packed (G2
decompression, aggregate public keys, hash to field, limbs), from the
verifier's ``bls.pack`` spans, in ms."""


def read(ctx):
    packs = ctx.spans_named("bls.pack")
    sets = sum(s.args.get("sets", 0) for s in packs if s.args)
    return sum(s.dur_ns for s in packs) / 1e6 / sets if sets else None
