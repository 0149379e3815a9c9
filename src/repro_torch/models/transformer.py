"""Model assembly: embedding → per-layer blocks → norm → logits, plus the
KV-cache decode path and the training loss.  One ``Model`` covers all ten
configured families (dense, MoE, SSM, hybrid, VLM, audio) and MLA —
family differences are config-driven.

Blocks live in an ``nn.ModuleList``, one module per layer, and run in a
Python loop with each layer's own attention window and sub-config: a MoE
config with ``moe_every`` = g > 1 (llama4) alternates g - 1 dense layers
and one MoE layer, as the reference's groups of g sub-layers do.  Caches
keep the reference's layout and keys: ``k``/``v`` (L, B, S, KH, hd; under
a mesh whose "model" axis splits the heads, this rank's KV heads), ``ckv``
(L, B, S, kvr), ``krope`` (L, B, S, rope), ``state`` (L, B, nh, hp, ds) in
f32, ``conv`` (L, B, K-1, conv_dim; under a mesh whose "model" axis splits
the SSM's heads, this rank's heads and channels, ``models.ssm``), and
``pos``, a Python int.

Training (``loss``, ``hidden_states``) runs the same blocks with autograd:
K2 and K3 then run as ``torch.autograd.Function``s whose backward is a
kernel too (``kernels.flash_attention_bwd``, ``kernels.ssd_chunk_bwd``).
``cfg.remat`` picks what a layer keeps for the backward, as the reference's
``jax.checkpoint`` around its layer scan: ``"none"`` keeps everything;
``"full"`` keeps only each layer's input and recomputes the layer in the
backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` is the
reference's ``dots_with_no_batch_dims_saveable`` policy, a selective
checkpoint (``create_selective_checkpoint_contexts``) that keeps the
outputs of the products with no batch dimension, the projections
(``aten.mm`` on the folded tokens: attention's and the SSM's in and out
projections, the MLP's, the MoE router's), and recomputes everything else:
K2 and K3 as whole operators, the MoE's expert ``bmm``s (the reference's
``ecd,edf->ecf`` has the batch dimension ``e``), norms, rope, gathers and
collectives.  A layer's last product, whose output only feeds the
residual sum (``Block.out_weight``), is not kept: no backward op reads it
(the recompute stops before it), and the reference keeps no residual for
it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.collectives import (all_gather_dim, all_reduce_max, psum,
                                       region_in, region_out, seq_partial,
                                       sum_grads)
from ..distributed.context import (axis_names, batch_axes, constrain_batch,
                                   constrain_tokens, current_mesh,
                                   model_axis_size, model_group, model_rank,
                                   use_mesh, use_seq_shard)
from ..distributed.sharding import gathered
from ..tracing import span
from .config import ArchConfig
from .layers import (MLA, MLP, Attention, Init, RMSNorm, _dtype, _linear,
                     rmsnorm)
from .moe import MoE, moe_block
from .ssm import SSM, init_ssm_cache

_SEQ_KEYS = ("k", "v", "ckv", "krope")
F32 = torch.float32
REMATS = ("none", "full", "dots")
# the products remat "dots" keeps: a projection of (tokens, d) by a weight
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, init: Init):
        super().__init__()
        dt = _dtype(cfg)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, dt, init)
        if cfg.attention == "mla":
            self.attn = MLA(cfg, init)
        elif cfg.attention in ("gqa", "swa"):
            self.attn = Attention(cfg, init)
        if cfg.uses_ssm:
            self.ssm = SSM(cfg, init)
            if cfg.family == "hybrid":
                self.ln_attn_out = RMSNorm(cfg.d_model, dt, init)
                self.ln_ssm_out = RMSNorm(cfg.d_model, dt, init)
        if cfg.uses_moe:
            self.ln2 = RMSNorm(cfg.d_model, dt, init)
            self.moe = MoE(cfg, init)
        elif cfg.d_ff:
            self.ln2 = RMSNorm(cfg.d_model, dt, init)
            self.mlp = MLP(cfg, init)

    def _ln(self, ln: RMSNorm, x: torch.Tensor) -> torch.Tensor:
        """One of the layer's norms on the residual stream: under
        Megatron-SP on this rank's rows, so its scale's gradient is summed
        over "model" (``seq_partial``)."""
        return rmsnorm(seq_partial(ln.scale), x, self.cfg.norm_eps)

    def _mix(self, attn, ssm) -> torch.Tensor:
        """The token mixer's residual update from the attention and/or SSM
        branch outputs (hybrid: both, normalised and averaged)."""
        if self.cfg.family == "hybrid":
            return 0.5 * (self._ln(self.ln_attn_out, attn)
                          + self._ln(self.ln_ssm_out, ssm))
        return ssm if self.cfg.uses_ssm else attn

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.uses_moe:
            x = x + moe_block(self.moe, self._ln(self.ln2, x), self.cfg,
                              mesh=current_mesh(),
                              batch_axes=batch_axes() or ("data",))
        elif self.cfg.d_ff:
            x = x + self.mlp(self._ln(self.ln2, x))
        return x

    def out_weight(self) -> torch.Tensor | None:
        """The weight of the product whose output this layer adds straight
        into the residual stream, where no later op of the layer reads it
        (the MLP's or the shared expert's ``wo``, or a lone mixer's output
        projection); None where the layer ends otherwise (the MoE's
        combine, the hybrid's normed mix).  Read at call time: under a mesh
        it is the value the call sees (this rank's rows of it where the
        layer is tensor-parallel)."""
        cfg = self.cfg
        if cfg.uses_moe:
            return self.moe.shared.wo if cfg.shared_expert_ff else None
        if cfg.d_ff:
            return self.mlp.wo
        if cfg.family == "hybrid":
            return None
        return self.ssm.w_out if cfg.uses_ssm else self.attn.wo

    def _gathered(self):
        """This layer's ``DTensor`` parameters as a call uses them: under a
        mesh with a "model" axis, the experts and the tensor-parallel
        attention, MLA, SSM and MLP leaves keep their "model" shards (each
        module's ``model_dims``), everything else at its full value; with
        no such axis, everything at its full value."""
        return gathered(self, keep=_model_keep())

    def forward(self, x: torch.Tensor, *, window: int = 0,
                seq_shard: bool = False):
        """Full-sequence forward; returns (x, this layer's cache entry).
        ``seq_shard``: Megatron-SP, the reference's training-path layout of
        the residual stream (``constrain_tokens``): ``x`` and the output
        are this rank's S/n rows, gathered into each tensor-parallel region
        and scattered out of it (the caller decides: a "model" axis of n >
        1 ranks that divides the sequence); prefill's is the batch's."""
        cfg = self.cfg
        with self._gathered(), use_seq_shard(seq_shard):
            h = self._ln(self.ln1, x)
            entry: dict = {}
            a = s = None
            if not cfg.is_attention_free:
                a, kv = self.attn(h, window=window)
                entry.update(kv)
            if cfg.uses_ssm:
                s, st = self.ssm(h)
                entry.update(st)
            x = constrain_tokens(x + self._mix(a, s), seq_shard=seq_shard)
            return constrain_tokens(self._ffn(x), seq_shard=seq_shard), entry

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """One token; updates this layer's cache views in place."""
        cfg = self.cfg
        with self._gathered():
            h = self._ln(self.ln1, x)
            a = s = None
            if not cfg.is_attention_free:
                a = self.attn.decode(h, cache, pos, window=window)
            if cfg.uses_ssm:
                s = self.ssm.decode(h, cache)
            return self._ffn(x + self._mix(a, s))


def _model_keep() -> tuple[str, ...]:
    """``gathered``'s ``keep`` under the installed mesh: the "model" shards
    where it has that axis."""
    mesh = current_mesh()
    return ("model",) if mesh is not None and "model" in axis_names(mesh) \
        else ()


def _block_out(blk: Block, x: torch.Tensor, window: int,
               mesh=None, seq_shard: bool = False) -> torch.Tensor:
    """``blk``'s output under ``mesh``: remat's recompute runs in the
    backward, on the autograd engine's own thread for CUDA tensors, where
    ``use_mesh``'s context variable is not set, so the mesh of the
    forward (and its Megatron-SP decision) is passed along.  A span
    (``tracing``), ``transformer.layer``, lets a trace tell the
    layers' forward and recompute from the backward."""
    with use_mesh(mesh), span("transformer.layer"):
        return blk(x, window=window, seq_shard=seq_shard)[0]


def _dots_policy(blk: Block):
    """remat "dots" for ``blk``: keep the output of every projection but
    the layer's last (``Block.out_weight``), recompute every other op."""
    def policy(ctx, op, *args, **kwargs):
        if op in _DOTS:
            w, last = args[-1], blk.out_weight()
            if last is None or (w is not last and w._base is not last):
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _dots_contexts(blk: Block):
    return create_selective_checkpoint_contexts(_dots_policy(blk))


def _chunk_xent(hx: torch.Tensor, lx: torch.Tensor, w32: torch.Tensor,
                v0: int = 0, group=None):
    """(sum of -log p(label), number of labels >= 0) over one chunk of
    tokens; logits in f32, as the reference's f32-accumulated head.  With a
    ``group``, ``w32`` holds the vocab columns [v0, v0 + its width) of a
    head split over it: the log-sum-exp is taken against the group's
    maximum of each row (no gradient) and the exponentials' sums summed
    over the group, and the label logit is the reference's masked sum over
    the rank's vocab ids (the one column a label in [v0, v1) selects,
    else 0), summed over the group.  The chunk's f32 hidden states enter
    through ``sum_grads``: each rank's gradient of them covers its columns,
    and is summed in f32 before it is rounded to the activations' dtype,
    as the unsplit head's is."""
    h32 = hx.to(F32)
    if group is not None:
        h32 = sum_grads(h32, group)
    logits = h32 @ w32
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        m = all_reduce_max(logits.detach().amax(dim=-1), group)
        lse = m + torch.log(psum(torch.exp(logits - m[:, None]).sum(-1),
                                 group))
    local = lx - v0
    mine = (local >= 0) & (local < logits.shape[1])
    ll = torch.where(mine, logits.gather(
        1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0], 0.0)
    if group is not None:
        ll = psum(ll, group)
    valid = (lx >= 0).to(F32)
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_xent(h: torch.Tensor, labels: torch.Tensor, w_head: torch.Tensor,
                 chunk: int, vocab: tuple | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy of hidden states ``h`` (T, d) through the
    head ``w_head`` (d, V) against ``labels`` (T,), labels < 0 ignored:
    ``chunk`` tokens at a time, each chunk's (chunk, V) f32 logits
    recomputed in the backward when autograd records, so no (T, V) logits
    are ever held.  The head is widened to f32 once, not per chunk.
    ``vocab`` = (v0, group): ``w_head`` is this rank's columns [v0, v0 +
    its width) of a vocab split over ``group`` (``Model``'s vocab-parallel
    head): each rank computes its columns' logits, and the loss and ``h``'s
    gradient (each rank's covers its columns) are summed over the group
    (``_chunk_xent``)."""
    v0, group = vocab if vocab is not None else (0, None)
    w32 = w_head.to(F32)
    loss_sum = torch.zeros((), dtype=F32, device=h.device)
    count = torch.zeros((), dtype=F32, device=h.device)
    for i in range(0, h.shape[0], chunk):
        hx, lx = h[i:i + chunk], labels[i:i + chunk]
        if torch.is_grad_enabled():
            part, n = checkpoint(_chunk_xent, hx, lx, w32, v0, group,
                                 use_reentrant=False)
        else:
            part, n = _chunk_xent(hx, lx, w32, v0, group)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0)


def _sub_cfgs(cfg: ArchConfig) -> list[ArchConfig]:
    """The sub-layer configs of one group of layers (llama4: [dense, moe]);
    layer j of the model has config ``_sub_cfgs(cfg)[j % g]``."""
    if cfg.uses_moe and cfg.moe_every > 1:
        dense = dataclasses.replace(cfg, num_experts=0, shared_expert_ff=0)
        return [dense] * (cfg.moe_every - 1) + [cfg]
    return [cfg]


def _layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer window sizes: 0 = full attention."""
    if cfg.attention != "swa" or not cfg.window:
        return [0] * cfg.num_layers
    return [0 if i in set(cfg.global_layers) else cfg.window
            for i in range(cfg.num_layers)]


def _gathering(method):
    """Run ``method`` with the model's ``DTensor`` parameters outside its
    layers (embedding, head, final norm, adapter) at their full values
    (``distributed.sharding.gathered``), but for the embedding's and the
    head's vocab shard over "model" (``Model.model_dims``); each layer
    gathers its own."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with gathered(self, skip="layers.", keep=_model_keep()):
            return method(self, *args, **kwargs)
    return wrapper


class Model(nn.Module):
    """The model of one ``ArchConfig`` with weights drawn from ``generator``
    (a ``torch.Generator`` on ``device``; seed 0 when omitted).  On the
    ``meta`` device nothing is drawn or allocated: the parameters are
    shapes only (``launch.specs.param_specs``).

    ``logits``, ``prefill``, ``extend_cache``, ``init_cache`` and
    ``decode_step`` follow the reference's methods; the parameters live in
    the module, so they take no ``params`` argument.  After
    ``distributed.sharding.shard_params`` the parameters are ``DTensor``s
    and each call works on this rank's batch shard: the top-level leaves
    are gathered for the call, each layer's for the layer, but for the
    "model" shards a layer computes on (``Block._gathered``: attention's,
    MLA's and the SSM's heads and the MLP's columns, tensor-parallel; the
    MoE's experts).

    The vocabulary is split over "model" the same way where it divides
    the axis (the rules' ``embed`` ("model", fsdp) and ``lm_head`` (fsdp,
    "model"); ``_vocab`` decides): a rank holds the embedding rows and
    head columns [v0, v1) through every call.  The embedding looks up the
    ids in [v0, v1) and sums the lookups over "model" (a single non-zero
    term per token: exact); the serving head computes the rank's V/n f32
    columns and gathers them along V, so callers get whole logits; the
    loss sums its parts over "model" (``chunked_xent``).  Where the vocab
    does not divide "model" the leaves are gathered whole, as before.

    ``loss`` and ``hidden_states`` run Megatron-SP where
    ``cfg.seq_shard_activations`` is set, the mesh's "model" axis has n >
    1 ranks and n divides the sequence (decided once a forward): the
    residual stream between the tensor-parallel regions, and so what remat
    "full" keeps of each layer, is this rank's S/n rows of it; the
    embedding's lookups are summed (or taken whole) and cut to the rank's
    rows, the final hidden states gathered.  Prefill and decode keep the
    batch's layout.
    """

    # the dim of the vocab each leaf keeps sharded over "model" under a
    # mesh (``distributed.sharding.gathered``)
    model_dims = {"embed": 0, "lm_head": 1}

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Model({cfg.name}): device {device} asked "
                               f"for, but torch.cuda.is_available() is False")
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        init = Init(device, generator)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.windows = _layer_windows(cfg)
        self.embed = init.normal((cfg.vocab_size, cfg.d_model), 0.02, dt)
        self.final_norm = RMSNorm(cfg.d_model, dt, init)
        subs = _sub_cfgs(cfg)
        if cfg.num_layers % len(subs):
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole groups of {len(subs)}")
        self.layers = nn.ModuleList(Block(subs[j % len(subs)], init)
                                    for j in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = init.normal((cfg.d_model, cfg.vocab_size), 0.02, dt)
        if cfg.frontend != "none":
            self.adapter = init.normal((cfg.d_model, cfg.d_model), 0.02, dt)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---- forward ----------------------------------------------------------

    def _vocab(self) -> tuple[int, Any] | None:
        """(v0, the "model" group) where the embedding holds this rank's
        vocab rows [v0, v0 + its rows) as a call sees it (a "model" axis
        of n > 1 ranks that divides the vocab); None where it holds them
        all.  The head's columns follow: the rules split them alike."""
        mesh = current_mesh()
        rows = (self.embed.to_local() if isinstance(self.embed, DTensor)
                else self.embed).shape[0]
        if model_axis_size(mesh) == 1 or rows == self.cfg.vocab_size:
            return None
        return model_rank(mesh) * rows, model_group(mesh)

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """Token ids (B, S) or, for a stub frontend, embeddings (B, S, d):
        torch tensors or anything ``np.asarray`` takes.  Under Megatron-SP
        (``use_seq_shard``) this rank's rows of the sequence."""
        key = "embeds" if self.cfg.frontend != "none" else "tokens"
        x = batch[key]
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        vocab = self._vocab() if key == "tokens" else None
        if key == "embeds":
            x = _linear(x.to(self.device, _dtype(self.cfg)), self.adapter)
        elif vocab is None:
            x = self.embed[x.to(self.device, torch.long)]
        else:
            rows = self.embed.shape[0]
            local = x.to(self.device, torch.long) - vocab[0]
            mine = (local >= 0) & (local < rows)
            x = torch.where(mine[..., None],
                            self.embed[local.clamp(0, rows - 1)], 0.0)
        return constrain_batch(region_out(
            x, None if vocab is None else vocab[1]))

    def unembed(self) -> torch.Tensor:
        """The head (d, V), or this rank's (d, V/n) columns of it where the
        vocab is split over "model" (``_vocab``)."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Serving's f32 logits (..., V): where the vocab is split, this
        rank's columns gathered along V over "model" (no gradient)."""
        h = rmsnorm(self.final_norm.scale, x, self.cfg.norm_eps)
        logits = h.float() @ self.unembed().float()
        vocab = self._vocab()
        return logits if vocab is None else all_gather_dim(logits, -1,
                                                           vocab[1])

    def _seq_shard(self, batch: dict) -> bool:
        """Whether a training forward of ``batch`` runs Megatron-SP: the
        config asks for it and the installed mesh's "model" axis has n > 1
        ranks that divide the sequence."""
        key = "embeds" if self.cfg.frontend != "none" else "tokens"
        n = model_axis_size()
        return (self.cfg.seq_shard_activations and n > 1
                and np.shape(batch[key])[1] % n == 0)

    @_gathering
    def hidden_states(self, batch: dict) -> torch.Tensor:
        """The final-normed hidden states (B, S, d) with autograd, each
        layer kept for the backward as ``cfg.remat`` says."""
        remat = self.cfg.remat
        if remat not in REMATS:
            raise ValueError(f"{self.cfg.name}: remat={remat!r}, not one of "
                             f"{REMATS}")
        sp = self._seq_shard(batch)
        with use_seq_shard(sp):
            x = self.embed_inputs(batch)
            for blk, w in zip(self.layers, self.windows):
                if remat != "none" and torch.is_grad_enabled():
                    kw = ({"context_fn": functools.partial(_dots_contexts,
                                                           blk)}
                          if remat == "dots" else {})
                    x = checkpoint(_block_out, blk, x, w, current_mesh(), sp,
                                   use_reentrant=False, **kw)
                else:
                    x = _block_out(blk, x, w, current_mesh(), sp)
            h = rmsnorm(seq_partial(self.final_norm.scale), x,
                        self.cfg.norm_eps)
            # under SP, the rows gathered: the whole hidden states on
            # every rank, as without it
            return region_in(h, None)

    @_gathering
    def loss(self, batch: dict) -> torch.Tensor:
        """Chunked softmax cross-entropy over ``batch["labels"]`` (B, S),
        labels < 0 ignored: ``cfg.loss_chunk`` tokens at a time, each
        chunk's (chunk, V) f32 logits recomputed in the backward, so no
        (T, V) logits are ever held (V/n columns a rank where the vocab is
        split over "model", ``chunked_xent`` summing the parts).  Mean
        over the kept labels, f32."""
        h = self.hidden_states(batch)
        B, S, d = h.shape
        labels = batch["labels"]
        if not isinstance(labels, torch.Tensor):
            labels = torch.as_tensor(np.asarray(labels))
        return chunked_xent(h.reshape(B * S, d),
                            labels.to(h.device, torch.long).reshape(B * S),
                            self.unembed(), min(self.cfg.loss_chunk, B * S),
                            self._vocab())

    @torch.no_grad()
    @_gathering
    def logits(self, batch: dict) -> torch.Tensor:
        """Full (B, S, V) logits in f32 — small inputs only (tests)."""
        x = self.embed_inputs(batch)
        for blk, w in zip(self.layers, self.windows):
            x, _ = blk(x, window=w)
        return self._head(x)

    @torch.no_grad()
    @_gathering
    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Process a prompt, returning (last-token logits (B, V), cache).

        The cache length equals the prompt length; callers wanting headroom
        pad via ``extend_cache``.  MLA caches the latent; SSM caches the
        final recurrent state + conv tail — so decode continues exactly.
        """
        x = self.embed_inputs(batch)
        entries = []
        for blk, w in zip(self.layers, self.windows):
            x, entry = blk(x, window=w)
            entries.append(entry)
        cache: dict[str, Any] = {kk: torch.stack([e[kk] for e in entries])
                                 for kk in entries[0]}
        cache["pos"] = x.shape[1]
        return self._head(x[:, -1:])[:, 0], cache

    @staticmethod
    def extend_cache(cache: dict, extra: int) -> dict:
        """Pad sequence-indexed cache entries by ``extra`` zero positions."""
        out = {}
        for kk, vv in cache.items():
            if kk in _SEQ_KEYS:
                shape = list(vv.shape)
                shape[2] = extra
                out[kk] = torch.cat([vv, vv.new_zeros(shape)], dim=2)
            else:
                out[kk] = vv
        return out

    # ---- decode -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> dict:
        """A zero cache of ``batch`` sequences of ``max_len`` positions in
        the reference's layout.  Under a mesh whose "model" axis splits the
        attention heads (call it under the mesh of the decode steps), K/V
        hold the KV heads this rank's query heads read
        (``layers.HeadShard``); where it splits the SSM's heads, ``state``
        holds the rank's heads and ``conv`` its channels (``models.ssm``).
        MLA's latent cache is whole on every rank."""
        cfg = self.cfg
        dt, dev, L = _dtype(cfg), self.device, cfg.num_layers
        cache: dict[str, Any] = {"pos": 0}
        if cfg.attention in ("gqa", "swa"):
            sh = self.layers[0].attn.head_shard()
            kh = cfg.num_kv_heads if sh is None else sh.kv1 - sh.kv0
            shape = (L, batch, max_len, kh, cfg.head_dim)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        elif cfg.attention == "mla":
            cache["ckv"] = torch.zeros((L, batch, max_len, cfg.kv_lora_rank),
                                       dtype=dt, device=dev)
            cache["krope"] = torch.zeros(
                (L, batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                device=dev)
        if cfg.uses_ssm:
            sc = init_ssm_cache(cfg, batch, dt, dev,
                                self.layers[0].ssm.head_shard())
            cache["state"] = sc["state"].expand(L, *sc["state"].shape).clone()
            cache["conv"] = sc["conv"].expand(L, *sc["conv"].shape).clone()
        return cache

    @torch.no_grad()
    @_gathering
    def decode_step(self, cache: dict, batch: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One token for every sequence.  batch: {"tokens": (B, 1)} or
        {"embeds": (B, 1, d)}.  Returns (logits (B, V), cache): the cache's
        tensors are updated in place and its ``pos`` advanced by one.  The
        step runs under the span ``model.decode_step`` (``tracing``)."""
        with span("model.decode_step"):
            x = self.embed_inputs(batch)
            pos = int(cache["pos"])
            for i, (blk, w) in enumerate(zip(self.layers, self.windows)):
                layer = {kk: vv[i] for kk, vv in cache.items()
                         if kk != "pos"}
                x = blk.decode(x, layer, pos, window=w)
            return self._head(x)[:, 0], dict(cache, pos=pos + 1)
