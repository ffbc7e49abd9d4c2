"""Adapters: the port's LMs -> Scission LayerGraph, the port of
``repro/models/graph_adapter.py``.

:func:`lm_to_graph`: each group of layers becomes one graph node
(Scission's block), embedding and unembedding are the terminal nodes, and
the residual stream is the single crossing tensor — so every group
boundary is a valid partition point, exactly like the paper's linear DNNs.

The DAG adapters emit branchy graphs for the DAG-general partitioner
(``fuse_block_dag`` / the SP solver):

* :func:`encdec_to_graph` — the encoder stack and the target embedding run
  as parallel branches off the token input, meeting at the decoder's
  cross-attention;
* :func:`moe_to_graph` — expert *shards* as parallel branches (replicated
  routing, local expert compute), summed at the combine with a residual
  fork→join edge;
* :func:`xlstm_to_graph` — each mLSTM sub-layer's residual skip is a
  graph-level fork→join edge, so the skip and the recurrent body can be
  placed independently.

The nodes' names, kinds, edges, FLOPs and parameter bytes are the
reference's.  Attention nodes run ``flash_attention`` (non-causal in the
encoder and the cross-attention), Mamba-2 and mLSTM nodes ``ssd_scan``, so
on the card the Scission loop times and runs the hand-written kernels.

The weights stay where they are (the card, as a rule) while
``LayerGraph.trace()`` runs the graph on ``meta`` tensors: a node given a
``meta`` input uses ``meta`` stand-ins of its weights.
"""

from __future__ import annotations

import torch

from ..core.graph import LayerGraph, LayerNode, TensorSpec
from . import layers as L
from .encdec import EncDecLM
from .lm import DecoderLM, _index, _norm
from .xlstm import mlstm, slstm


def _like(tree, x: torch.Tensor):
    """``tree``, or ``meta`` stand-ins of its tensors when ``x`` is on
    ``meta`` (shape tracing)."""
    if not x.is_meta:
        return tree
    return L.tree_map(lambda a: a.to("meta"), tree)


def _tree_bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in L.tree_leaves(tree))


def lm_to_graph(model: DecoderLM, params, *, batch: int, seq_len: int
                ) -> LayerGraph:
    cfg = model.cfg
    g = LayerGraph(cfg.name)
    prev = g.input(TensorSpec((batch, seq_len), torch.int32), name="tokens")

    def embed_fn(tokens):
        return model._embed_inputs(_like({"embed": params["embed"]}, tokens),
                                   tokens)

    d = cfg.d_model
    prev = g.add(LayerNode("embed", "embed", apply=embed_fn, flops=0.0,
                           param_bytes=cfg.vocab * d * 2), [prev])

    shared = params.get("shared_block")
    for gi in range(cfg.n_groups):
        pg = _index(params["layers"], gi)

        def group_fn(x, pg=pg):
            shared_x = None if shared is None else _like(shared, x)
            positions = torch.arange(seq_len, dtype=torch.int32,
                                     device=x.device)[None, :]
            y, _, _ = model._apply_group(_like(pg, x), shared_x, x, None,
                                         positions=positions,
                                         cache_len=None, mode="train")
            return y

        pbytes = _tree_bytes(pg)
        per_tok_flops = 2.0 * pbytes / 2   # ~2 flops per bf16 param weight
        g.add(LayerNode(f"group{gi}", "block", apply=group_fn,
                        flops=per_tok_flops * batch * seq_len,
                        param_bytes=pbytes), [prev])
        prev = len(g.nodes) - 1

    def head_fn(x):
        p = _like({"final_norm": params["final_norm"],
                   "embed": params["embed"]}, x)
        h = _norm(cfg)(p["final_norm"], x[:, -1:])
        return L.unembed(p["embed"], h, softcap=cfg.final_softcap)

    g.add(LayerNode("head", "unembed", apply=head_fn,
                    flops=2.0 * cfg.vocab * d * batch,
                    param_bytes=0), [prev])
    g.trace()
    return g


def encdec_to_graph(model: EncDecLM, params, *, batch: int, seq_len: int,
                    enc_splits: int = 2) -> LayerGraph:
    """EncDecLM -> branchy LayerGraph (teacher-forced text-to-text mode:
    the source and target sequences share the input tokens).

    The token input forks into the **encoder branch** (source embedding,
    then ``enc_splits`` encoder sub-stacks ending in the encoder's final
    norm) and the **target-embedding branch**; both meet at the decoder
    stack, whose cross-attention reads the encoder memory.
    """
    cfg = model.cfg
    g = LayerGraph(cfg.name)
    tok = g.input(TensorSpec((batch, seq_len), torch.int32), name="tokens")
    normf = _norm(cfg)
    d = cfg.d_model

    def embed_fn(tokens):
        return model._embed_tokens(_like({"embed": params["embed"]}, tokens),
                                   tokens, 0)

    # -- encoder branch ----------------------------------------------------
    prev = g.add(LayerNode("src_embed", "embed", apply=embed_fn, flops=0.0,
                           param_bytes=cfg.vocab * d * 2), [tok])
    n_enc = cfg.encoder_layers
    splits = max(1, min(enc_splits, n_enc))
    bounds = [round(i * n_enc / splits) for i in range(splits + 1)]
    for si in range(splits):
        lo, hi = bounds[si], bounds[si + 1]
        layers = [_index(params["encoder"], gi) for gi in range(lo, hi)]
        last = si == splits - 1

        def enc_fn(x, layers=layers, last=last):
            for pg in layers:
                x = model.encoder_layer(_like(pg, x), x)
            if last:
                x = normf(_like(params["enc_final_norm"], x), x)
            return x

        pbytes = (hi - lo) * _tree_bytes(_index(params["encoder"], 0))
        prev = g.add(LayerNode(f"enc{si}", "block", apply=enc_fn,
                               flops=pbytes * batch * seq_len,
                               param_bytes=pbytes), [prev])
    memory = prev

    # -- target-embedding branch -------------------------------------------
    tgt = g.add(LayerNode("tgt_embed", "embed", apply=embed_fn, flops=0.0,
                          param_bytes=cfg.vocab * d * 2), [tok])

    # -- join: the decoder stack (cross-attention reads the memory) --------
    def dec_fn(x, mem):
        positions = torch.arange(seq_len, dtype=torch.int32,
                                 device=x.device)[None, :]
        y, _ = model._decoder_stack(_like({"decoder": params["decoder"]}, x),
                                    x, mem, None, positions=positions,
                                    cache_len=None, mode="train")
        return y

    dec_bytes = _tree_bytes(params["decoder"])
    dec = g.add(LayerNode("decoder", "block", apply=dec_fn,
                          flops=dec_bytes * batch * seq_len,
                          param_bytes=dec_bytes), [tgt, memory])

    def head_fn(x):
        p = _like({"final_norm": params["final_norm"],
                   "embed": params["embed"]}, x)
        h = normf(p["final_norm"], x[:, -1:])
        return L.unembed(p["embed"], h, softcap=cfg.final_softcap)

    g.add(LayerNode("head", "unembed", apply=head_fn,
                    flops=2.0 * cfg.vocab * d * batch, param_bytes=0), [dec])
    g.trace()
    return g


def moe_to_graph(p, *, batch: int, seq_len: int, d_model: int,
                 n_experts: int, top_k: int, n_shards: int = 2,
                 activation: str = "silu", name: str = "moe") -> LayerGraph:
    """One MoE layer as an expert-parallel LayerGraph.

    ``p`` is a :func:`.moe.moe_spec` parameter tree.  The input activations
    (bf16) fork into ``n_shards`` branches; each replicates the routing and
    computes only its local experts' gated contribution (experts ``s``,
    ``s + n_shards``, ...).  The combine node sums the shard outputs and
    the residual stream, which reaches it over a direct fork→join edge.

    Routing is evaluated densely per shard (every local expert weighted by
    its top-k gate, zero for unrouted tokens): the token-choice top-k of
    :func:`.moe.moe` without capacity dropping.
    """
    E = p["router"].shape[1]
    shards = [list(range(s, n_experts, n_shards)) for s in range(n_shards)]
    shards = [s for s in shards if s]
    g = LayerGraph(name)
    x0 = g.input(TensorSpec((batch, seq_len, d_model), torch.bfloat16),
                 name="acts")
    act = L._ACTIVATIONS[activation]

    def gates(q, x):
        logits = torch.einsum("bsd,de->bse", x.float(), q["router"].float())
        if n_experts < E:
            pad = torch.arange(E, device=x.device) >= n_experts
            logits = logits - pad.to(logits.dtype) * 1e30
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.topk(probs, top_k, dim=-1)
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        # dense per-expert gate: (B, S, E)
        experts = torch.arange(E, device=x.device)
        dense = torch.zeros_like(probs)
        for k in range(top_k):
            dense = dense + vals[..., k, None] * \
                (idx[..., k, None] == experts).float()
        return dense

    shard_nodes = []
    expert_bytes = _tree_bytes({k: p[k] for k in ("w_gate", "w_up", "w_down")})
    for si, ids in enumerate(shards):

        def shard_fn(x, ids=tuple(ids)):
            q = _like(p, x)
            dense = gates(q, x)
            y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for e in ids:
                h = act(L.matmul(x, q["w_gate"][e])) * \
                    L.matmul(x, q["w_up"][e])
                ye = L.matmul(h, q["w_down"][e])
                y = y + dense[..., e, None] * ye.float()
            return y.to(x.dtype)

        shard_nodes.append(g.add(LayerNode(
            f"experts{si}", "moe_shard", apply=shard_fn,
            flops=6.0 * batch * seq_len * d_model * p["w_up"].shape[2]
            * len(ids),
            param_bytes=expert_bytes * len(ids) // E), [x0]))

    def combine_fn(*ins):
        *ys, x = ins
        out = x.float()
        for y in ys:
            out = out + y.float()
        return out.to(x.dtype)

    join = g.add(LayerNode("combine", "add", apply=combine_fn,
                           flops=float(batch * seq_len * d_model
                                       * (len(shards) + 1)),
                           param_bytes=0), [*shard_nodes, x0])
    g.add(LayerNode("out", "identity", apply=lambda x: x, flops=0.0,
                    param_bytes=0), [join])
    g.trace()
    return g


def xlstm_to_graph(model: DecoderLM, params, *, batch: int, seq_len: int
                   ) -> LayerGraph:
    """DecoderLM with an xLSTM pattern -> LayerGraph whose mLSTM residual
    skips are graph-level fork→join edges.

    Each ``mlstm`` sub-layer becomes a (core, add) pair: the core node
    computes the normed recurrent update (``ssd_scan`` on the card), and the
    add node sums it with the residual stream arriving over a direct edge
    from the fork, so the SP decomposition sees one single-branch parallel
    region per mLSTM.  ``slstm`` sub-layers (their residuals inside) stay
    chain nodes.
    """
    cfg = model.cfg
    g = LayerGraph(cfg.name)
    prev = g.input(TensorSpec((batch, seq_len), torch.int32), name="tokens")
    normf = _norm(cfg)
    d = cfg.d_model

    def embed_fn(tokens):
        return model._embed_inputs(_like({"embed": params["embed"]}, tokens),
                                   tokens)

    prev = g.add(LayerNode("embed", "embed", apply=embed_fn, flops=0.0,
                           param_bytes=cfg.vocab * d * 2), [prev])

    for gi in range(cfg.n_groups):
        pg = _index(params["layers"], gi)
        for name, kind in zip(model.sub_names, model.kinds):
            sp = pg[name]
            pbytes = _tree_bytes(sp)
            if kind == "mlstm":

                def core_fn(x, sp=sp):
                    q = _like(sp, x)
                    h, _ = mlstm(q["core"], cfg, normf(q["norm"], x))
                    return h

                core = g.add(LayerNode(
                    f"g{gi}_{name}", "mlstm", apply=core_fn,
                    flops=pbytes * batch * seq_len, param_bytes=pbytes),
                    [prev])
                prev = g.add(LayerNode(
                    f"g{gi}_{name}_add", "add", apply=lambda h, x: x + h,
                    flops=float(batch * seq_len * d), param_bytes=0),
                    [core, prev])
            elif kind == "slstm":

                def s_fn(x, sp=sp):
                    if x.is_meta:
                        # shape tracing: the block keeps x's shape and
                        # dtype, and its S serial steps on meta tensors
                        # would take the tracer seconds
                        return torch.empty_like(x)
                    y, _ = slstm(sp["core"], cfg, x)
                    return y

                prev = g.add(LayerNode(
                    f"g{gi}_{name}", "slstm", apply=s_fn,
                    flops=pbytes * batch * seq_len, param_bytes=pbytes),
                    [prev])
            else:
                raise ValueError(
                    f"xlstm_to_graph supports mlstm/slstm groups, got "
                    f"{kind!r}; use lm_to_graph for mixed patterns")

    def head_fn(x):
        p = _like({"final_norm": params["final_norm"],
                   "embed": params["embed"]}, x)
        h = normf(p["final_norm"], x[:, -1:])
        return L.unembed(p["embed"], h, softcap=cfg.final_softcap)

    g.add(LayerNode("head", "unembed", apply=head_fn,
                    flops=2.0 * cfg.vocab * d * batch, param_bytes=0),
          [prev])
    g.trace()
    return g
