"""GCN (Kipf & Welling, arXiv:1609.02907) with segment-sum message passing.

Message passing from first principles, as in the reference: gather source
features along an edge list, scale by the symmetric-norm edge weight
1/√(deg_s·deg_d), and segment-sum into destinations
(:func:`repro_torch.models.layers.segment_sum`).

Distribution (full-batch, ogb_products scale): under rules that map the
"nodes" logical axis to mesh axes, nodes are split in blocks over them
and edges over the "edges" axes (the "nodes" axes where that rule is
unmapped). Each layer's aggregation then runs one position at a time, as
the reference's ``shard_map`` does: a position all-gathers the whole
[N, H] hidden matrix, sums its edge block into a partial [N, H], and the
partials are reduce-scattered back to node blocks
(:func:`repro_torch.dist.collectives.all_gather`,
:func:`~repro_torch.dist.collectives.psum_scatter`). With no mesh, or no
"nodes" rule, it is one segment sum: the same values up to the order of
the float sums.

Minibatch (GraphSAGE-style fanout sampling) consumes the fixed-shape
padded subgraphs of :class:`repro_torch.data.pipeline.NeighborSampler`;
batched small graphs (molecules) go through :func:`batched_graph_apply`.

The weights carry no gradient and nothing here turns autograd off.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.dist.collectives import all_gather, psum_scatter
from repro_torch.dist.sharding import current_mesh, mesh_axis_names
from repro_torch.models import layers as L

__all__ = [
    "GCN",
    "gcn_spec",
    "gcn_init",
    "gcn_apply",
    "node_xent",
    "batched_graph_apply",
    "graph_xent",
    "sym_norm_weights",
]


class GCN(L.ParamTree):
    """A GCN's parameters in the reference's layout (``w0``, ``w1``, ...,
    each ``{"w": [d_in, d_out]}``), with its config."""

    def __init__(self, tree: Dict, cfg: GNNConfig):
        super().__init__(tree)
        self.cfg = cfg


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device, dtype=dtype)


def sym_norm_weights(src, dst, n_nodes: int) -> torch.Tensor:
    """Symmetric normalisation 1/√(deg_s·deg_d) (cfg.norm == "sym"), where
    a node's degree is half its in- plus out-edges."""
    src, dst = torch.as_tensor(src).long(), torch.as_tensor(dst).long()
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    deg = (L.segment_sum(ones, dst, n_nodes)
           + L.segment_sum(ones, src, n_nodes))
    deg = torch.clamp(deg, min=1.0) * 0.5
    return torch.rsqrt(deg[src] * deg[dst])


def gcn_spec(cfg: GNNConfig, d_feat: int) -> Dict:
    dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {f"w{i}": L.dense_spec(dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def gcn_init(gen: torch.Generator, cfg: GNNConfig, d_feat: int,
             device: DeviceLike = None) -> GCN:
    """Random float32 weights from ``gen`` on ``device`` (``None``: the
    card)."""
    return GCN(L.init_leaves(gcn_spec(cfg, d_feat), gen, torch.float32,
                             resolve_device(device)), cfg)


def _blocks(x: torch.Tensor, mesh, axes) -> list:
    """Each mesh position's block of ``x``'s rows over ``axes``, on its
    device (a view where it already lies there)."""
    size = math.prod(mesh.shape[a] for a in axes)
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split into {size} blocks "
                         f"over {axes} (pad the graph)")
    step = x.shape[0] // size
    blocks = []
    for pos in mesh.positions():
        b = mesh.block_of(pos, axes)
        blocks.append(x[b * step:(b + 1) * step].to(mesh.device_at(pos)))
    return blocks


def _aggregate(h, src, dst, w, n_nodes: int, mean_deg=None):
    """Σ_{(s→d)} w·h[s] into d (divided by ``mean_deg`` when given).
    Sharded when a mesh with a "nodes" rule is active."""
    mesh = current_mesh()
    node_axes = mesh_axis_names("nodes")
    if mesh is None or not node_axes:
        agg = L.segment_sum(h[src] * w[:, None], dst, n_nodes)
        if mean_deg is not None:
            agg = agg / mean_deg[:, None]
        return agg

    edge_axes = mesh_axis_names("edges") or node_axes
    h_full = all_gather(_blocks(h, mesh, node_axes), mesh, node_axes)
    partials = [
        L.segment_sum(hf[s] * w_[:, None], d, n_nodes)
        for hf, s, d, w_ in zip(h_full, _blocks(src, mesh, edge_axes),
                                _blocks(dst, mesh, edge_axes),
                                _blocks(w, mesh, edge_axes))
    ]
    del h_full
    out = psum_scatter(partials, mesh, node_axes)
    if mean_deg is not None:
        out = [o / md[:, None]
               for o, md in zip(out, _blocks(mean_deg, mesh, node_axes))]
    # the global [N, H]: node block b from the first position holding it
    first = {}
    for i, pos in enumerate(mesh.positions()):
        first.setdefault(mesh.block_of(pos, node_axes), i)
    return torch.cat([out[first[b]].to(h.device) for b in sorted(first)])


def gcn_apply(
    params,
    cfg: GNNConfig,
    feats,                   # [N, F]
    src,                     # [E] int
    dst,                     # [E] int
    edge_w,                  # [E] f32 (sym-norm weights; 0 for padding)
    mean_deg=None,           # [N] (aggregator="mean"); the pipeline's
                             # precomputed degrees, else counted here
) -> torch.Tensor:
    """Returns node logits [N, n_classes] on the weights' device."""
    tree = L.as_tree(params)
    dev = tree["w0"]["w"].device
    feats = _on(feats, dev, torch.float32)
    src, dst = _on(src, dev).long(), _on(dst, dev).long()
    edge_w = _on(edge_w, dev, torch.float32)
    n = feats.shape[0]
    if mean_deg is not None:
        mean_deg = _on(mean_deg, dev, torch.float32)
    elif cfg.aggregator == "mean":
        deg = L.segment_sum((edge_w > 0).float(), dst, n)
        mean_deg = torch.clamp(deg, min=1.0)

    h = feats
    for i in range(cfg.n_layers):
        h = L.dense(tree[f"w{i}"], h)           # transform-then-aggregate
        h = _aggregate(h, src, dst, edge_w, n, mean_deg)
        if i < cfg.n_layers - 1:
            h = F.relu(h)
    return h


def node_xent(logits: torch.Tensor, labels, mask) -> torch.Tensor:
    """Cross-entropy on labelled nodes. labels: [N] int; mask: [N] f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = _on(labels, logp.device).long()
    mask = _on(mask, logp.device, torch.float32)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# --------------------------------------------------------------- molecule
def batched_graph_apply(
    params,
    cfg: GNNConfig,
    feats,                   # [B, Nn, F]
    src,                     # [B, Ne] (ids local to each graph)
    dst,                     # [B, Ne]
    edge_w,                  # [B, Ne]
) -> torch.Tensor:
    """Graph classification over batched small graphs -> [B, n_classes]:
    the B graphs as one graph of B·Nn nodes (each graph's ids offset by
    its first node), then a mean-pool of each graph's node logits. No
    edge joins two graphs, so this is the reference's ``vmap`` of
    :func:`gcn_apply` over the batch."""
    dev = L.as_tree(params)["w0"]["w"].device
    feats = _on(feats, dev, torch.float32)
    b, nn_, _ = feats.shape
    first = (torch.arange(b, device=dev) * nn_)[:, None]
    logits = gcn_apply(
        params, cfg, feats.reshape(b * nn_, -1),
        (_on(src, dev).long() + first).reshape(-1),
        (_on(dst, dev).long() + first).reshape(-1),
        _on(edge_w, dev, torch.float32).reshape(-1))
    return torch.mean(logits.reshape(b, nn_, -1), dim=1)  # mean-pool readout


def graph_xent(logits: torch.Tensor, labels) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = _on(labels, logp.device).long()
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))
