"""All decode time over all decode steps of the window, in ms: the
engine's own ``Completion.decode_s`` (ended by a synchronize) over the
``new_tokens - 1`` steps of each batch."""


def read(ctx):
    batches = ctx.run.batches
    steps = sum(max(len(c.tokens) for c in b.completions) - 1
                for b in batches)
    if steps <= 0:
        return None
    return 1e3 * sum(b.completions[0].decode_s for b in batches) / steps
