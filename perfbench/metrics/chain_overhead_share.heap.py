"""The chain's share of the traced window's host time: the seconds the
heap cell's timers (``entries.heap_federation.Timers``: key generation,
signing and verifying, fingerprints and digests, block drafts,
confirmations and appends, receipts) counted in its federations, over the
window, in percent (the paper's "chain overhead")."""


def read(ctx):
    if ctx.trace is None or "chain_s" not in ctx.counts:
        return None
    return 100.0 * ctx.counts["chain_s"] / ctx.window_s
