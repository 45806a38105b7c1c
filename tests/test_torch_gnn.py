"""The port's GCN against the JAX package on the CPU: the config, the
synthetic graphs (full-batch, molecules) and the neighbour sampler array
for array, weights carried across by ``repro_torch.convert``, and
``gcn_apply`` full-batch, on sampled subgraphs and batched, with its
losses. The mesh branch runs on a (2, 4) mesh of CPU positions under the
reference's rules (nodes and edges over both axes) and is held against
the reference's dense result; the list-form all-gather and reduce-scatter
it uses are held against their definitions.

Tolerance: 1e-5 against the reference and between the mesh and the dense
port (float32 sums in other orders); 0 for the data, the weights and the
collectives' data movement."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipeline
from repro.models import gnn as RG
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import NeighborSampler, gnn_full_graph, molecule_batch
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S
from repro_torch.models import gnn as G

from _torch_parity import CPU

TOL = dict(rtol=1e-5, atol=1e-5)
MESH = S.make_mesh((2, 4), ("data", "model"), [CPU])
# small graphs of each shape kind (the full ones are the chip's)
FULL = dict(n_nodes=300, n_edges=1100, d_feat=12, n_classes=7)
SAMPLER = dict(n_nodes=400, avg_degree=6, d_feat=10, n_classes=5,
               fanouts=(3, 2))
MOLECULE = dict(batch=5, n_nodes=9, n_edges=14, d_feat=6, n_classes=2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


def _weights(d_feat, cfg=None):
    cfg = cfg or get_arch("gcn-cora").CONFIG
    ref_cfg = ref_get_arch("gcn-cora").CONFIG
    params = RG.gcn_init(jax.random.key(0), ref_cfg, d_feat)
    mine = convert.gcn_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device=CPU)
    return ref_cfg, cfg, params, mine


def test_config_equals_the_reference_field_by_field():
    mine, theirs = get_arch("gcn-cora"), ref_get_arch("gcn-cora")
    assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(theirs.CONFIG)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert [(s.name, s.kind, s.params) for s in mine.SHAPES] == \
        [(s.name, s.kind, s.params) for s in theirs.SHAPES]


@pytest.mark.parametrize("seed,pad_to", [(0, 1), (3, 8)])
def test_full_graph_equals_the_reference(seed, pad_to):
    _same_arrays(gnn_full_graph(**FULL, seed=seed, pad_to=pad_to),
                 ref_pipeline.gnn_full_graph(**FULL, seed=seed, pad_to=pad_to))


@pytest.mark.parametrize("seed,step", [(0, 0), (2, 5)])
def test_molecule_batch_equals_the_reference(seed, step):
    _same_arrays(molecule_batch(**MOLECULE, seed=seed, step=step),
                 ref_pipeline.molecule_batch(**MOLECULE, seed=seed, step=step))


@pytest.mark.parametrize("seed,step", [(0, 0), (4, 9)])
def test_neighbor_sampler_equals_the_reference(seed, step):
    mine = NeighborSampler.random_graph(**SAMPLER, seed=seed)
    theirs = ref_pipeline.NeighborSampler.random_graph(**SAMPLER, seed=seed)
    for field in ("indptr", "indices", "feats", "labels"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    seeds = np.random.default_rng(seed).choice(400, 16, replace=False)
    got = mine.sample(seeds, step=step)
    _same_arrays(got, theirs.sample(seeds, step=step))
    f1, f2 = SAMPLER["fanouts"]
    shapes = NeighborSampler.subgraph_shapes(16, f1, f2, 10)
    assert shapes == ref_pipeline.NeighborSampler.subgraph_shapes(16, f1, f2,
                                                                  10)
    assert (got["nodes"].shape[0], got["src"].shape[0]) == shapes


def test_weights_round_trip_and_init_has_the_reference_layout():
    _, cfg, params, mine = _weights(12)
    tree = jax.tree.map(np.asarray, params)
    back = convert.gcn_params_to_numpy(mine)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
    init = G.gcn_init(_gen(0), cfg, 12, device=CPU)
    assert isinstance(init, G.GCN)
    assert jax.tree.map(lambda t: tuple(t.shape), init.tree()) == \
        jax.tree.map(lambda a: tuple(a.shape), params)
    with pytest.raises(ValueError, match="config wants"):
        convert.gcn_params_from_numpy(
            tree, dataclasses.replace(cfg, n_classes=3), device=CPU)
    with pytest.raises(ValueError, match="keys"):
        convert.gcn_params_from_numpy(
            tree, dataclasses.replace(cfg, n_layers=3), device=CPU)


def test_sym_norm_weights_match_the_reference():
    g = gnn_full_graph(**FULL, seed=1)
    got = G.sym_norm_weights(torch.from_numpy(g["src"]),
                             torch.from_numpy(g["dst"]), FULL["n_nodes"])
    want = RG.sym_norm_weights(jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
                               FULL["n_nodes"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), g["edge_w"], **TOL)


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
@pytest.mark.parametrize("given_mean_deg", [True, False])
def test_full_batch_gcn_and_node_xent_match_the_reference(aggregator,
                                                          given_mean_deg):
    g = gnn_full_graph(**FULL, seed=2, pad_to=8)
    cfg = dataclasses.replace(get_arch("gcn-cora").CONFIG,
                              aggregator=aggregator)
    ref_cfg, _, params, mine = _weights(FULL["d_feat"], cfg)
    ref_cfg = dataclasses.replace(ref_cfg, aggregator=aggregator)
    md = g["mean_deg"] if given_mean_deg else None
    got = G.gcn_apply(mine, cfg, g["feats"], g["src"], g["dst"], g["edge_w"],
                      md)
    want = RG.gcn_apply(params, ref_cfg, *(jnp.asarray(g[k]) for k in (
        "feats", "src", "dst", "edge_w")),
        None if md is None else jnp.asarray(md))
    assert got.shape == (g["feats"].shape[0], cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        G.node_xent(got, g["labels"], g["label_mask"]).item(),
        float(RG.node_xent(want, jnp.asarray(g["labels"]),
                           jnp.asarray(g["label_mask"]))), **TOL)


def test_sampled_subgraph_gcn_matches_the_reference():
    sampler = NeighborSampler.random_graph(**SAMPLER, seed=3)
    sub = sampler.sample(np.arange(8), step=1)
    ref_cfg, cfg, params, mine = _weights(SAMPLER["d_feat"])
    got = G.gcn_apply(mine, cfg, sub["feats"], sub["src"], sub["dst"],
                      sub["edge_w"])
    want = RG.gcn_apply(params, ref_cfg, *(jnp.asarray(sub[k]) for k in (
        "feats", "src", "dst", "edge_w")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        G.node_xent(got, sub["labels"], sub["seed_mask"]).item(),
        float(RG.node_xent(want, jnp.asarray(sub["labels"]),
                           jnp.asarray(sub["seed_mask"]))), **TOL)


def test_batched_graphs_and_graph_xent_match_the_reference():
    mol = molecule_batch(**MOLECULE, seed=0, step=0)
    ref_cfg, cfg, params, mine = _weights(MOLECULE["d_feat"])
    got = G.batched_graph_apply(mine, cfg, mol["feats"], mol["src"],
                                mol["dst"], mol["edge_w"])
    want = RG.batched_graph_apply(params, ref_cfg, *(jnp.asarray(mol[k]) for k
                                  in ("feats", "src", "dst", "edge_w")))
    assert got.shape == (MOLECULE["batch"], cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        G.graph_xent(got, mol["labels"]).item(),
        float(RG.graph_xent(want, jnp.asarray(mol["labels"]))), **TOL)


# ------------------------------------------------------------- the mesh
@pytest.mark.parametrize("rules", [
    S.DEFAULT_RULES,                               # nodes, edges: both axes
    dict(S.DEFAULT_RULES, edges=None),             # edges follow the nodes
    dict(S.DEFAULT_RULES, nodes="model", edges="model"),
], ids=["default", "edges_unmapped", "model_only"])
@pytest.mark.parametrize("given_mean_deg", [True, False])
def test_mesh_branch_matches_the_dense_reference(rules, given_mean_deg):
    g = gnn_full_graph(**FULL, seed=5, pad_to=8)
    ref_cfg, cfg, params, mine = _weights(FULL["d_feat"])
    md = g["mean_deg"] if given_mean_deg else None
    want = RG.gcn_apply(params, ref_cfg, *(jnp.asarray(g[k]) for k in (
        "feats", "src", "dst", "edge_w")),
        None if md is None else jnp.asarray(md))
    seen = []
    real = G.psum_scatter

    def spy(shards, mesh, axes):
        seen.append((len(shards), tuple(shards[0].shape)))
        return real(shards, mesh, axes)

    G.psum_scatter = spy
    try:
        with S.mesh_rules(MESH, rules):
            got = G.gcn_apply(mine, cfg, g["feats"], g["src"], g["dst"],
                              g["edge_w"], md)
    finally:
        G.psum_scatter = real
    n = g["feats"].shape[0]
    # one reduce-scatter a layer, each position's partial over every node
    assert seen == [(8, (n, cfg.d_hidden)), (8, (n, cfg.n_classes))]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mesh_branch_refuses_a_graph_that_does_not_split():
    g = gnn_full_graph(**FULL, seed=5)           # 300 nodes: not 8 blocks
    _, cfg, _, mine = _weights(FULL["d_feat"])
    with S.mesh_rules(MESH, S.DEFAULT_RULES), \
            pytest.raises(ValueError, match="pad the graph"):
        G.gcn_apply(mine, cfg, g["feats"], g["src"], g["dst"], g["edge_w"])


def test_all_gather_and_psum_scatter_over_the_mesh():
    rng = np.random.default_rng(0)
    shards = [torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32))
              for _ in range(MESH.size)]
    positions = list(MESH.positions())
    for axes in (("data", "model"), ("model",), "data"):
        names = (axes,) if isinstance(axes, str) else axes
        gathered = C.all_gather(shards, MESH, axes)
        scattered = C.psum_scatter(shards, MESH, axes)
        for i, pos in enumerate(positions):
            group = [positions.index(p) for p in MESH.group_of(pos, names)]
            np.testing.assert_array_equal(
                gathered[i].numpy(),
                np.concatenate([shards[j].numpy() for j in group]))
            step = 16 // len(group)
            b = MESH.block_of(pos, names)
            want = sum(shards[j][b * step:(b + 1) * step] for j in group)
            np.testing.assert_array_equal(scattered[i].numpy(), want.numpy())
    with pytest.raises(ValueError, match="split"):
        C.psum_scatter([s[:7] for s in shards], MESH, ("data", "model"))
    with pytest.raises(ValueError, match="shards"):
        C.all_gather(shards[:3], MESH, "data")
    with pytest.raises(ValueError, match="needs a mesh"):
        C.all_gather(shards, None, "data")
