"""K2's share of its roofline in the prefills of the traced segment, in
%: Σ bound ÷ Σ device time of the kernels launched under the operator
(by the enclosing operator, not by kernel name), the bound from
``costs.kernels`` at the chip's peaks."""
from perfbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, ("repro_torch::flash_attention",
                          "repro_torch::flash_attention_lse"))
