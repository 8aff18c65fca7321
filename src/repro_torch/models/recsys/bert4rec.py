"""BERT4Rec (arXiv:1904.06690): a bidirectional transformer over item
sequences with cloze (masked-item) training, the counterpart of the JAX
package's ``repro.models.recsys.bert4rec``, in float32 throughout.

The hot path at production scale is the item *embedding table* (10^6
rows) — the lookup on the way in and the full-vocab scoring matmul on
the way out.  ``retrieval_score`` is the 1M-candidate retrieval shape:
one user state against a candidate id list, a gather and one product.

Attention goes through ``models.attention.bidirectional_attention``:
K4 on a CUDA tensor (``causal=False``, and its hand-written backward
while a gradient is taken), its plain version on a CPU one.  K4's
float32 products at BERT4Rec's head dim of 32 are three TF32 passes on
the tensor cores (each operand split into a tf32 hi and lo, lo.hi +
hi.lo + hi.hi summed in float32: only the lo.lo term, about 2^-22 of a
product, is dropped), held to the float32 limits of the FMA tiles they
replace.  As in the reference's code (its comment says otherwise), no
key is masked: PAD positions enter every softmax, and only ``x *
pad_mask`` after each block zeroes them.  GELU is the tanh form
(``jax.nn.gelu``'s default).  The model's own matmuls are IEEE float32:
torch's TF32 switch stays off, its default.

Parameters are the reference's pytree as dicts and lists of float32
tensors (``train.tree`` walks them in ``jax.tree.leaves``' order).

Under DTensor placements (``launch.tasks``' partitioned cells) the same
functions take DTensors: each table lookup is vocab-parallel where the
table's rows are cut over ``model`` (``layers.gather_rows``), and K4
runs on each rank's own rows (``bidirectional_attention``).  A plain
table keeps ``take_rows``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, gather_rows,
                                      layernorm, layernorm_init)
from repro_torch.models.params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000        # production-size vocab (PAD=0 included)
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    max_seq: int = 200
    d_ff_mult: int = 4
    compute_dtype: torch.dtype = torch.float32

    @property
    def vocab(self) -> int:
        # n_items + PAD(0 overlay) + [MASK], rounded up to a 512 multiple
        # so the table shards evenly over any production mesh axis.
        raw = self.n_items + 2
        return -(-raw // 512) * 512

    @property
    def mask_id(self) -> int:
        return self.n_items + 1


def init_params(gen: torch.Generator, cfg: BERT4RecConfig, device=None):
    """Random float32 weights drawn from ``gen`` (on its device, then
    moved to ``device`` if given) in the reference's shapes and scales;
    weights to compare with it come through ``params_from_jax``."""
    dev = gen.device if device is None else resolve_device(device)
    d, f = cfg.embed_dim, cfg.d_ff_mult * cfg.embed_dim

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dev)

    params = {
        "item_embed": normal((cfg.vocab, d), d**-0.5),
        "pos_embed": normal((cfg.max_seq, d), 0.02),
        "ln_in": layernorm_init(d, device=dev),
        "ln_out": layernorm_init(d, device=dev),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "ln1": layernorm_init(d, device=dev),
            "wqkv": normal((d, 3 * d), d**-0.5),
            "wo": normal((d, d), d**-0.5),
            "ln2": layernorm_init(d, device=dev),
            "w1": normal((d, f), d**-0.5),
            "b1": torch.zeros(f, device=dev),
            "w2": normal((f, d), f**-0.5),
            "b2": torch.zeros(d, device=dev),
        })
    return params


def params_from_jax(tree, device=None):
    """The JAX package's parameters (``jax.tree.map(np.asarray, params)``:
    ``item_embed``, ``pos_embed``, ``ln_in`` / ``ln_out`` and the
    ``blocks`` list) as the port's tree on ``device``."""
    return tree_from_jax(tree, device)


def encode(params, cfg: BERT4RecConfig, items: torch.Tensor) -> torch.Tensor:
    """items [B, S] -> hidden [B, S, D] (bidirectional)."""
    b, s = items.shape
    d = cfg.embed_dim
    h = cfg.n_heads
    x = gather_rows(params["item_embed"], items)
    x = x + params["pos_embed"][None, :s]
    x = layernorm(params["ln_in"], x)
    pad_mask = (items != 0).to(torch.float32)          # PAD=0
    for blk in params["blocks"]:
        xn = layernorm(blk["ln1"], x)
        q, k, v = (xn @ blk["wqkv"]).split(d, dim=-1)
        q = q.reshape(b, s, h, d // h)
        k = k.reshape(b, s, h, d // h)
        v = v.reshape(b, s, h, d // h)
        o = attn.bidirectional_attention(q, k, v)
        x = x + (o.reshape(b, s, d) @ blk["wo"])
        xn = layernorm(blk["ln2"], x)
        f = F.gelu(xn @ blk["w1"] + blk["b1"], approximate="tanh")
        x = x + (f @ blk["w2"] + blk["b2"])
        x = x * pad_mask[..., None]
    return layernorm(params["ln_out"], x)


def logits_all_items(params, h: torch.Tensor) -> torch.Tensor:
    """Full-vocab scoring (training / offline bulk): [..., D] -> [..., V]."""
    return h @ params["item_embed"].T


def loss_fn(params, cfg: BERT4RecConfig, batch) -> torch.Tensor:
    """Cloze objective: predict the original item at masked positions.

    batch: items [B,S] (with MASK substitutions), labels [B,S],
    loss_mask [B,S] in {0,1}.
    """
    h = encode(params, cfg, batch["items"])
    logits = logits_all_items(params, h)
    return cross_entropy(logits, batch["labels"], batch["loss_mask"])


def loss_sampled(params, cfg: BERT4RecConfig, batch) -> torch.Tensor:
    """Production cloze loss for 10^6-item catalogs: sampled softmax over
    shared in-batch negatives.

    batch: items [B,S], masked_pos [B,M] int (in [0, S)), labels [B,M]
    int, negatives [Nneg] int (shared across the batch).

    The positive sits in slot 0 of each row's logits; its log-softmax is
    taken as ``pos - logaddexp(pos, logsumexp(neg))``, the reference's
    ``log_softmax(concat([pos, neg]))[..., 0]`` without the concatenated
    ``[B, M, 1 + Nneg]`` copy and its gradient.
    """
    h = encode(params, cfg, batch["items"])            # [B, S, D]
    pos = batch["masked_pos"].long()
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
    pos_emb = gather_rows(params["item_embed"], batch["labels"])
    neg_emb = gather_rows(params["item_embed"], batch["negatives"])
    pos_logit = (hm * pos_emb).sum(dim=-1).float()     # [B, M]
    neg_logit = (hm @ neg_emb.T).float()               # [B, M, Nneg]
    lse = torch.logaddexp(pos_logit, torch.logsumexp(neg_logit, dim=-1))
    return -(pos_logit - lse).mean()


def serve_score(params, cfg: BERT4RecConfig, items: torch.Tensor):
    """Online inference: hidden state at the final (MASK) position scored
    against the full catalog. Returns logits [B, V]."""
    h = encode(params, cfg, items)
    return logits_all_items(params, h[:, -1])


def retrieval_score(params, cfg: BERT4RecConfig, items: torch.Tensor,
                    candidate_ids: torch.Tensor) -> torch.Tensor:
    """Retrieval shape: 1 user sequence vs ``n_candidates`` item ids.
    items [1, S]; candidate_ids [C] -> scores [C]."""
    h = encode(params, cfg, items)[:, -1]              # [1, D]
    cand = gather_rows(params["item_embed"], candidate_ids)  # [C, D]
    return (h @ cand.T)[0]
