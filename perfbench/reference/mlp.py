"""The SwiGLU feed-forward block, plain float32: wo(silu(x wg) * (x wi))."""
from __future__ import annotations

from torch.nn.functional import silu

PREFIX = "mlp"


def spec(a) -> dict:
    d, ff = a.d_model, a.d_ff
    return {"wi": ((d, ff), "normal"), "wg": ((d, ff), "normal"),
            "wo": ((ff, d), "out")}


def forward(nx, p: dict, x, a, positions):
    return nx.mm(silu(nx.mm(x, p["wg"])) * nx.mm(x, p["wi"]), p["wo"])
