"""A model's operations from its configuration's shapes, for ``mfu``.

Every product of the forward counts 2 a multiply-add: the projections, the
feed-forward block, MLA's low-rank products, the SSM's in- and
out-projections, and the head at the positions whose logits are taken.
The embedding lookup counts nothing.  Attention counts 2 H (Dk + Dv) a
kept causal pair.  The SSD counts its chunked products at the
configuration's chunk: C Bᵀ a group and (C Bᵀ ∘ L) x a head over each
chunk's Q (Q + 1) / 2 pairs, the chunk state and the output from the
carried state (Q ds hp a head each), and the state pass (ds hp a head a
chunk).  A training step counts three forwards; recomputation is not
counted.
"""
from __future__ import annotations


def _get(m: dict, key: str, default=0):
    return m.get(key, default)


def layer_matmul_flops_per_token(m: dict) -> int:
    """2 x the weights a token's products read in one layer."""
    d = m["d_model"]
    w = 0
    if m.get("attention") == "mla":
        H = m["num_heads"]
        nope, rp, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                        m["v_head_dim"])
        qr, kvr = m["q_lora_rank"], m["kv_lora_rank"]
        w += d * qr + qr * H * (nope + rp) + d * (kvr + rp)
        w += kvr * H * (nope + vd) + H * vd * d
    if _get(m, "ssm_state"):
        di = m["ssm_expand"] * d
        nh = di // m["ssm_head_dim"]
        gs = m["ssm_groups"] * m["ssm_state"]
        w += d * (2 * di + 2 * gs + nh) + di * d
    if _get(m, "d_ff"):
        w += 3 * d * m["d_ff"]
    return 2 * w


def attention_flops(m: dict, seq_len: int) -> int:
    """One layer's attention over one sequence of ``seq_len`` tokens."""
    if m.get("attention") != "mla":
        return 0
    dk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    pairs = seq_len * (seq_len + 1) // 2
    return 2 * m["num_heads"] * (dk + m["v_head_dim"]) * pairs


def ssd_flops(m: dict, seq_len: int) -> int:
    """One layer's SSD over one sequence of ``seq_len`` tokens."""
    if not _get(m, "ssm_state"):
        return 0
    Q = m["ssm_chunk"]
    nc = -(-seq_len // Q)
    di = m["ssm_expand"] * m["d_model"]
    hp, ds, G = m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    nh = di // hp
    pairs = Q * (Q + 1) // 2
    per_chunk = (2 * G * pairs * ds + 2 * nh * pairs * hp
                 + 2 * 2 * nh * Q * ds * hp + 2 * nh * ds * hp)
    return nc * per_chunk


def forward_flops(m: dict, seq_lens: list[int], head_tokens: int) -> int:
    """The forward of sequences of ``seq_lens`` tokens, the head taken at
    ``head_tokens`` positions in all."""
    L = m["num_layers"]
    tokens = sum(seq_lens)
    flops = L * layer_matmul_flops_per_token(m) * tokens
    flops += L * sum(attention_flops(m, s) + ssd_flops(m, s)
                     for s in seq_lens)
    return flops + 2 * m["d_model"] * m["vocab_size"] * head_tokens


def train_step_flops(m: dict, batch: int, seq_len: int) -> int:
    """A training step: three forwards, the head at every token."""
    return 3 * forward_flops(m, [seq_len] * batch, batch * seq_len)


def prefill_flops(m: dict, prompt_lens: list[int]) -> int:
    """A prefill of the real prompt tokens, the head at each prompt's
    last."""
    return forward_flops(m, prompt_lens, len(prompt_lens))
