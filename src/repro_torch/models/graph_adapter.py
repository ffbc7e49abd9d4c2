"""Adapter: the port's decoder-only LMs -> Scission LayerGraph, the port of
``repro/models/graph_adapter.py``'s :func:`lm_to_graph`.

Each group of layers becomes one graph node (Scission's block), embedding
and unembedding are the terminal nodes, and the residual stream is the
single crossing tensor — so every group boundary is a valid partition
point, exactly like the paper's linear DNNs.  The nodes' names, kinds,
FLOPs and parameter bytes are the reference's.  A group node's attention
runs ``flash_attention`` (and a Mamba-2 group's SSD ``ssd_scan``), so on
the card the Scission loop times and runs the hand-written kernels.

The weights stay where they are (the card, as a rule) while
``LayerGraph.trace()`` runs the graph on ``meta`` tensors: a node given a
``meta`` input uses ``meta`` stand-ins of its weights.  The DAG adapters of
the reference (encoder-decoder, MoE, xLSTM) come with those models
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from ..core.graph import LayerGraph, LayerNode, TensorSpec
from . import layers as L
from .lm import DecoderLM, _index, _norm


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
