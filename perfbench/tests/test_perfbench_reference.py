"""The plain reference against the port's CPU path at tiny sizes in
float32, the reference's chunked SSD against the recurrence it stands for,
and its AdamW against the port's."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT, TINY

from perfbench.harness import program, weights
from perfbench.reference import adamw, decoder, ssm
from perfbench.reference.common import Arch
from perfbench.reference.numerics import Numerics

F32 = torch.float32
NX = Numerics("float32")


def tiny_cfg(name: str) -> dict:
    cfg = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    cfg["model"].update(TINY[name], dtype="float32")
    return cfg


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_logits_agree_with_the_port(name, seed):
    cfg = tiny_cfg(name)
    w = weights.make(cfg, seed, "cpu")
    net = program.load_model(cfg, w, "cpu")
    tokens = torch.randint(0, 256, (1, 37),
                           generator=torch.Generator().manual_seed(seed))
    want = net.logits({"tokens": tokens})[0]
    at = [0, 11, 36]
    got = decoder.logits_at(NX, Arch(cfg["model"]), cfg["layer"], w,
                            tokens[0], at)
    torch.testing.assert_close(got, want[at], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TINY))
def test_loss_and_gradients_agree_with_the_port(name):
    cfg = tiny_cfg(name)
    cfg["model"]["remat"] = "none"
    w = weights.make(cfg, 9, "cpu")
    net = program.load_model(cfg, {k: v.clone() for k, v in w.items()},
                             "cpu")
    net.requires_grad_(True)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, 256, (2, 24), generator=g)
    labels = torch.randint(0, 256, (2, 24), generator=g)
    want = net.loss({"tokens": tokens, "labels": labels})
    want.backward()
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    got = decoder.loss(NX, Arch(cfg["model"]), cfg["layer"], params, tokens,
                       labels, chunk=16)
    got.backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k, p in net.named_parameters():
        torch.testing.assert_close(params[k].grad, p.grad, rtol=1e-3,
                                   atol=1e-5, msg=k)


@pytest.mark.parametrize("S, Q, G", [(19, 8, 1), (32, 8, 2), (5, 8, 1)])
def test_chunked_ssd_is_the_recurrence(S, Q, G):
    g = torch.Generator().manual_seed(S)
    b, nh, hp, ds = 2, 4, 3, 5
    x = torch.randn(b, S, nh, hp, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, nh, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(nh, generator=g, dtype=torch.float64) * 4
    B = torch.randn(b, S, G, ds, generator=g, dtype=torch.float64)
    C = torch.randn(b, S, G, ds, generator=g, dtype=torch.float64)
    h = torch.zeros(b, nh, hp, ds, dtype=torch.float64)
    want = []
    per = nh // G
    Bh, Ch = B.repeat_interleave(per, 2), C.repeat_interleave(per, 2)
    for t in range(S):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + (x[:, t] * dt[:, t, :, None])[..., None] * Bh[:, t, :, None])
        want.append(torch.einsum("bhps,bhs->bhp", h, Ch[:, t]))

    class F64(Numerics):
        def mm(self, a, b):
            return a @ b

    got = ssm.ssd(F64(), x, dt, A, B, C, Q)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-9,
                               atol=1e-9)


def test_adamw_is_the_ports():
    """Three steps of the reference's AdamW and the port's, from the same
    bfloat16 leaves and gradients, give the same leaves and moments."""
    from repro_torch.training import AdamW, cosine_schedule

    opt = json.loads((ROOT / "perfbench/configs/minicpm3-4b.json")
                     .read_text())["optimizer"]
    g = torch.Generator().manual_seed(2)
    shapes = {"embed": (16, 8), "layers.0.ln1.scale": (8,),
              "layers.0.attn.wq_a": (8, 4), "final_norm.scale": (8,)}
    p0 = {k: (torch.randn(s, generator=g) * 0.02).to(torch.bfloat16)
          for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) for k, s in shapes.items()}
             for _ in range(3)]
    sched = dict(opt["schedule"], warmup=2)     # past the warm-up at step 3
    opt = dict(opt, schedule=sched)
    lr = cosine_schedule(sched["peak"], warmup=sched["warmup"],
                         total=sched["total"], floor=sched["floor"])
    port = AdamW(learning_rate=lr, b1=opt["b1"], b2=opt["b2"],
                 eps=opt["eps"], weight_decay=opt["weight_decay"],
                 clip_norm=opt["clip_norm"], state_dtype=torch.bfloat16)
    pp = {k: v.clone() for k, v in p0.items()}
    state = port.init(pp)
    ref_p = {k: v.to(F32).requires_grad_() for k, v in p0.items()}
    ref = adamw.AdamW(opt, ref_p, {k: torch.bfloat16 for k in shapes})
    for gr in grads:
        port.update({k: v.to(torch.bfloat16) for k, v in gr.items()},
                    state, pp)
        for k, p in ref_p.items():
            p.grad = gr[k].to(torch.bfloat16).to(F32)
        ref.update(ref_p)
    for k in shapes:
        torch.testing.assert_close(ref_p[k].detach(), pp[k].to(F32),
                                   rtol=0, atol=0)
        torch.testing.assert_close(ref.m[k], state["m"][k], rtol=0, atol=0)
        torch.testing.assert_close(ref.v[k], state["v"][k], rtol=0, atol=0)
