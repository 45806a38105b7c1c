"""gcn-cora [arXiv:1609.02907]: 2-layer GCN, d_hidden=16, mean aggregator,
symmetric normalisation. Shape set spans full-batch small (cora),
fanout-sampled minibatch (reddit-scale), full-batch large (ogbn-products)
and batched small molecule graphs. The graphs are synthetic, drawn from a
seed (:mod:`repro_torch.data.pipeline`); nothing is downloaded."""

from repro_torch.configs.base import GNNConfig, ShapeSpec

CONFIG = GNNConfig(
    name="gcn-cora",
    n_layers=2,
    d_hidden=16,
    n_classes=7,
    aggregator="mean",
    norm="sym",
)

SHAPES = (
    ShapeSpec.make(
        "full_graph_sm", "gnn_full",
        n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7,
    ),
    ShapeSpec.make(
        "minibatch_lg", "gnn_minibatch",
        n_nodes=232_965, n_edges=114_615_892, d_feat=602, n_classes=41,
        batch_nodes=1024, fanout1=15, fanout2=10,
    ),
    ShapeSpec.make(
        "ogb_products", "gnn_full",
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47,
    ),
    ShapeSpec.make(
        "molecule", "gnn_batched",
        n_nodes=30, n_edges=64, batch=128, d_feat=32, n_classes=2,
    ),
)


def reduced() -> GNNConfig:
    return CONFIG  # already laptop-scale; shapes are reduced instead
