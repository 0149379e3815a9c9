"""The prefill's share of the chip's peak: the model operations of the
window's prefills over their real (unpadded) prompt tokens
(``costs.model``) over the prefills' time as the engine clocks it
(``Completion.prefill_s``, ended by a synchronize) times the peak rate,
in %."""
from perfbench.costs.model import prefill_flops


def read(ctx):
    batches = ctx.run.batches
    flops = sum(prefill_flops(ctx.config["model"],
                              [len(p.tokens) for p in b.prompts])
                for b in batches)
    seconds = sum(b.completions[0].prefill_s for b in batches)
    return 100.0 * flops / (seconds * ctx.peaks["flops_per_s"])
