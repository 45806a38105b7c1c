"""Cells: (architecture × input-shape × mesh) → a runnable program.

A Cell packages the step function, its arguments, their shardings on the
active mesh, and the analytic MODEL_FLOPS for the roofline's
useful-compute ratio (the reference's ``launch/cells.py``, name for name).
A cell is built inside a ``mesh_rules`` context.

The reference's arguments are ``ShapeDtypeStruct``s, lowered and compiled
without a device allocation. Here the arguments are tensors on the cell's
``device``:

* ``"meta"`` (the dry run): empty tensors of the reference's shapes.
  Nothing is allocated, so every cell builds on any host, and
  :func:`repro_torch.launch.op_cost.count_cost` counts ``cell.fn`` on them.
* ``"cpu"`` (the tests) or the card (``None``): values drawn from ``seed``
  that the cell's function runs on — tokens in the vocabulary, ids in
  their tables, edge endpoints among the nodes, 0/1 masks, and for the PIR
  cells the bit planes of a random store.

Parameters and train states are built by the port's own ``init_*`` and
``make_train_step(...)[0]`` on that device; their shapes are the
reference's ``jax.eval_shape`` results. ``in_shardings`` are the
``(mesh, P)`` pairs of :func:`repro_torch.dist.params.tree_named_shardings`
on the active mesh, as the reference's ``NamedSharding``s. The port runs a
cell eagerly: the shardings describe the placement the reference compiles
for (the dry run sizes each argument's block by them), and
``donate_argnums`` is kept for the reader. Two arguments differ on purpose:
the decode cell's ``pos`` is a Python int (``decode_step`` takes
``int(pos)``), and the PIR cells' masks and planes are uint8, where the
reference's are bf16 (the parity kernel's operands; 0/1 either way).
"""

from __future__ import annotations

import dataclasses
import math
import os as _os
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import (
    GNNConfig, LMConfig, PIRConfig, RecSysConfig, ShapeSpec,
)
from repro_torch.data.pipeline import NeighborSampler
from repro_torch.db import packing
from repro_torch.dist import collectives
from repro_torch.dist.params import (
    _map_with_paths,
    generic_param_specs,
    lm_param_specs,
    tree_named_shardings,
)
from repro_torch.dist.sharding import (
    Mesh, P, axis_size, current_mesh, logical_to_spec, mesh_axis_names,
)
from repro_torch.kernels.parity_matmul import parity_matmul_packed
from repro_torch.models import gnn, recsys as R, transformer as T
from repro_torch.models.layers import segment_sum
from repro_torch.train.train_step import (
    TrainState,
    default_optimizer,
    gnn_full_loss_fn,
    gnn_minibatch_loss_fn,
    gnn_molecule_loss_fn,
    lm_loss_fn,
    make_train_step,
    recsys_loss_fn,
)

__all__ = ["Cell", "build_cell", "build_cell_sanitized", "rules_for_cell",
           "cell_to_device", "pir_store_words", "SKIP"]

SKIP = "skip"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Optional[Callable] = None
    args: Tuple = ()
    in_shardings: Any = None
    donate_argnums: Tuple[int, ...] = ()
    model_flops: float = 0.0
    skip_reason: Optional[str] = None
    rules_override: Optional[Dict] = None


def _ns(*logical):
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a cell is built inside a mesh_rules context")
    return (mesh, logical_to_spec(*logical))


def _is_sharding(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], Mesh)
            and isinstance(x[1], P))


def _shape_of(arg) -> Tuple[int, ...]:
    return tuple(arg.shape) if hasattr(arg, "shape") else ()


def _map_shardings(fn, shardings, args):
    """``fn(sharding, arg)`` over the leaves of a shardings tree and the
    same leaves of its arguments (dicts, lists and tuples, named ones
    too)."""
    if _is_sharding(shardings):
        return fn(shardings, args)
    if isinstance(shardings, dict):
        return {k: _map_shardings(fn, v, args[k]) for k, v in shardings.items()}
    vals = [_map_shardings(fn, s, a) for s, a in zip(shardings, args)]
    if hasattr(shardings, "_fields"):
        return type(shardings)(*vals)
    return type(shardings)(vals)


def _sanitize_shardings(shardings, args):
    """Drop per-dim sharding where the dim isn't divisible by the mesh-axis
    product (jax rejects uneven jit-argument shardings). Affects e.g.
    embed tables with dim 10/18 (can't FSDP the feature dim) and tiny
    query batches — correctness-neutral, memory noted in EXPERIMENTS.md."""
    mesh = current_mesh()

    def one(sh, arg):
        shape = _shape_of(arg)
        parts = list(sh[1]) + [None] * (len(shape) - len(sh[1]))
        new = []
        for i, part in enumerate(parts):
            if part is None:
                new.append(None)
                continue
            axes = (part,) if isinstance(part, str) else part
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            new.append(part if shape[i] % size == 0 else None)
        return (mesh, P(*new))

    return _map_shardings(one, shardings, args)


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _mesh_size() -> int:
    mesh = current_mesh()
    return math.prod(mesh.shape.values())


# --------------------------------------------------------------------------
# arguments: empty on meta, drawn from the seed elsewhere
# --------------------------------------------------------------------------
class _Draw:
    """A cell's argument tensors on ``device``: empty of the shape on
    ``meta``, values from one generator seeded with ``seed`` elsewhere
    (the parameters are drawn first, then the arguments in order)."""

    def __init__(self, device: torch.device, seed: int):
        self.dev = device
        self.meta = device.type == "meta"
        self.gen = torch.Generator(
            device="cpu" if self.meta else device).manual_seed(seed)

    def ints(self, shape, hi: int, lo: int = 0) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=torch.int32, device=self.dev)
        return torch.randint(lo, max(hi, lo + 1), shape, generator=self.gen,
                             device=self.dev, dtype=torch.int32)

    def normal(self, shape, dtype=torch.float32, scale=1.0) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        # drawn in its own dtype: a 30 GB bf16 cache never exists in f32
        x = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=dtype)
        return x if scale == 1.0 else x.mul_(scale)

    def uniform(self, shape) -> torch.Tensor:
        """float32 in [0, 1)."""
        if self.meta:
            return torch.empty(shape, device=self.dev)
        return torch.rand(shape, generator=self.gen, device=self.dev)

    def coins(self, shape, dtype=torch.float32, p=0.5) -> torch.Tensor:
        """0/1 of ``dtype``, each 1 with probability ``p``."""
        if self.meta:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        u = torch.rand(shape, generator=self.gen, device=self.dev)
        return (u < p).to(dtype)


# --------------------------------------------------------------------------
# opt-state sharding: mirror param specs through the optimizer state tree
# --------------------------------------------------------------------------
def _flat_with_paths(tree, prefix: str = ""):
    """(path, leaf) of a spec tree, a partition spec a leaf."""
    if isinstance(tree, P):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_with_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _state_shardings(state, param_spec_tree):
    """TrainState(params, opt_state, comp_state, step) shardings."""
    mesh = current_mesh()
    param_sh = tree_named_shardings(param_spec_tree)
    flat_specs = dict(_flat_with_paths(param_spec_tree))

    def opt_leaf(path, leaf):
        ps = path
        # strip optimizer-tree prefixes/suffixes to find the param path
        for prefix in ("m/", "v/", "second/"):
            if ps.startswith(prefix):
                ps = ps[len(prefix):]
                break
        suffix = None
        for sfx in ("/row", "/col", "/v"):
            if ps.endswith(sfx):
                suffix = sfx
                ps = ps[: -len(sfx)]
                break
        spec = flat_specs.get(ps)
        if spec is None:
            return (mesh, P(*([None] * leaf.ndim)))
        parts = list(spec)
        if suffix == "/row":
            parts = parts[:-1]
        elif suffix == "/col":
            parts = parts[:-2] + parts[-1:]
        parts = (parts + [None] * leaf.ndim)[: leaf.ndim]
        return (mesh, P(*parts))

    opt_sh = _map_with_paths(state.opt_state, opt_leaf)
    comp_sh = param_sh if state.comp_state else {}
    return TrainState(
        params=param_sh,
        opt_state=opt_sh,
        comp_state=comp_sh,
        step=(mesh, P()),
    )


def _replicated(tree):
    """A fully replicated sharding for every leaf of ``tree``."""
    mesh = current_mesh()
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_replicated(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return (mesh, P(*([None] * getattr(tree, "ndim", 0))))


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------
def _lm_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _lm_variant() -> str:
    """LM-train perf-iteration selector (EXPERIMENTS.md §Perf):
    baseline    : Megatron TP(model) × FSDP(data) × SP residuals
    fsdp        : pure ZeRO-3 — batch over every axis, no tensor
                  parallelism (dense models: kills the per-layer TP
                  activation psums/gathers)
    fsdp_dots   : + remat policy saves dot outputs (less recompute)"""
    return _os.environ.get("REPRO_LM_VARIANT", "baseline")


def _lm_train_cell(arch, cfg: LMConfig, sp: ShapeSpec, draw: _Draw) -> Cell:
    p = sp.p()
    b, s = p["global_batch"], p["seq_len"]
    variant = _lm_variant()
    if variant == "fsdp_dots":
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    mb = 4 if variant == "mb4" else 1
    opt = default_optimizer(cfg)
    init_fn, step_fn = make_train_step(lm_loss_fn(cfg), opt, microbatches=mb)

    state = init_fn(T.init_lm(draw.gen, cfg, draw.dev))
    specs = lm_param_specs(state.params)
    state_sh = _state_shardings(state, specs)
    batch_sh = {"tokens": _ns("batch", None)}
    tokens = draw.ints((b, s), cfg.vocab)

    toks_per_step = b * s
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=step_fn,
        args=(state, {"tokens": tokens}),
        in_shardings=(state_sh, batch_sh),
        donate_argnums=(0,),
        model_flops=6.0 * cfg.params_active * toks_per_step,
    )


def _lm_prefill_cell(arch, cfg: LMConfig, sp: ShapeSpec, draw: _Draw) -> Cell:
    p = sp.p()
    b, s = p["global_batch"], p["seq_len"]
    params = T.init_lm(draw.gen, cfg, draw.dev).tree()
    specs = lm_param_specs(params)
    fn = partial(_prefill_fn, cfg=cfg, max_len=s)
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=fn,
        args=(params, draw.ints((b, s), cfg.vocab)),
        in_shardings=(tree_named_shardings(specs), _ns("batch", None)),
        model_flops=2.0 * cfg.params_active * b * s
        + 4.0 * b * s * s * cfg.n_heads * cfg.head_dim / 2,  # causal attn
    )


def _prefill_fn(params, tokens, *, cfg, max_len):
    return T.prefill(params, cfg, tokens, max_len)


def _decode_fn(params, cache, token, pos, *, cfg):
    return T.decode_step(params, cfg, cache, token, pos)


def _lm_decode_cell(arch, cfg: LMConfig, sp: ShapeSpec, long: bool,
                    draw: _Draw) -> Cell:
    p = sp.p()
    b, s = p["global_batch"], p["seq_len"]
    if long and cfg.full_attention_only:
        return Cell(
            arch=arch, shape=sp.name, kind=sp.kind,
            skip_reason=(
                "pure full-attention arch: 524k-token cell skipped per brief "
                "(DESIGN.md §4 — sub-quadratic attention required)"
            ),
        )
    params = T.init_lm(draw.gen, cfg, draw.dev).tree()
    specs = lm_param_specs(params)
    dt = _lm_dtype(cfg)
    cache = T.KVCache(
        k=draw.normal((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim), dt),
        v=draw.normal((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim), dt),
    )
    cache_sh = T.KVCache(
        k=_ns(None, "batch", "kv_seq", None, None),
        v=_ns(None, "batch", "kv_seq", None, None),
    )
    token = draw.ints((b, 1), cfg.vocab)
    pos = s - 1  # the last slot: the step attends over the whole cache

    attn_flops = 4.0 * b * s * cfg.n_heads * cfg.head_dim
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=partial(_decode_fn, cfg=cfg),
        args=(params, cache, token, pos),
        in_shardings=(tree_named_shardings(specs), cache_sh, _ns("batch", None), _ns()),
        donate_argnums=(1,),
        model_flops=2.0 * cfg.params_active * b + attn_flops,
    )


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------
def _gnn_state(cfg: GNNConfig, d_feat: int, loss_fn, draw: _Draw):
    opt = default_optimizer(cfg)
    init_fn, step_fn = make_train_step(loss_fn, opt)
    state = init_fn(gnn.gcn_init(draw.gen, cfg, d_feat, draw.dev))
    return step_fn, state, _replicated(state)


def _gnn_flops(n, e, f, h, c, train=True):
    fwd = 2.0 * (n * f * h + e * h + n * h * c + e * c)
    return fwd * (3.0 if train else 1.0)


def _graph(draw: _Draw, n: int, e: int, n_real: int, e_real: int):
    """src, dst, sym-norm edge_w [e] over ``n_real`` nodes; edges past
    ``e_real`` are padding (weight 0)."""
    src = draw.ints((e,), n_real)
    dst = draw.ints((e,), n_real)
    if draw.meta:
        return src, dst, torch.empty((e,), device=draw.dev)
    w = gnn.sym_norm_weights(src, dst, n)
    w[e_real:] = 0.0
    return src, dst, w


def _gnn_full_cell(arch, cfg: GNNConfig, sp: ShapeSpec, draw: _Draw) -> Cell:
    p = sp.p()
    shards = _mesh_size()
    n = _pad_to(p["n_nodes"], shards)
    e = _pad_to(p["n_edges"], shards)
    f, c = p["d_feat"], p["n_classes"]
    cfg = dataclasses.replace(cfg, n_classes=c)
    step_fn, state, state_sh = _gnn_state(cfg, f, gnn_full_loss_fn(cfg), draw)

    src, dst, edge_w = _graph(draw, n, e, p["n_nodes"], p["n_edges"])
    if draw.meta:
        mean_deg = torch.empty((n,), device=draw.dev)
    else:
        mean_deg = torch.clamp(segment_sum((edge_w > 0).float(), dst, n),
                               min=1.0)
    batch = {
        "feats": draw.normal((n, f)),
        "src": src,
        "dst": dst,
        "edge_w": edge_w,
        "labels": draw.ints((n,), c),
        "label_mask": draw.coins((n,)),
        "mean_deg": mean_deg,
    }
    batch_sh = {
        "feats": _ns("nodes", None),
        "src": _ns("edges"),
        "dst": _ns("edges"),
        "edge_w": _ns("edges"),
        "labels": _ns("nodes"),
        "label_mask": _ns("nodes"),
        "mean_deg": _ns("nodes"),
    }
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=step_fn, args=(state, batch),
        in_shardings=(state_sh, batch_sh),
        donate_argnums=(0,),
        model_flops=_gnn_flops(n, e, f, cfg.d_hidden, c),
    )


def _gnn_minibatch_cell(arch, cfg: GNNConfig, sp: ShapeSpec,
                        draw: _Draw) -> Cell:
    p = sp.p()
    b, f1, f2 = p["batch_nodes"], p["fanout1"], p["fanout2"]
    n_sub, e_sub = NeighborSampler.subgraph_shapes(b, f1, f2, p["d_feat"])
    f, c = p["d_feat"], p["n_classes"]
    cfg = dataclasses.replace(cfg, n_classes=c)
    step_fn, state, state_sh = _gnn_state(cfg, f, gnn_minibatch_loss_fn(cfg),
                                          draw)

    src, dst, edge_w = _graph(draw, n_sub, e_sub, n_sub, e_sub)
    batch = {
        "feats": draw.normal((n_sub, f)),
        "src": src,
        "dst": dst,
        "edge_w": edge_w,
        "labels": draw.ints((n_sub,), c),
        "seed_mask": draw.coins((n_sub,), p=b / n_sub),
    }
    batch_sh = {
        "feats": _ns("nodes", None),
        "src": _ns("edges"),
        "dst": _ns("edges"),
        "edge_w": _ns("edges"),
        "labels": _ns("nodes"),
        "seed_mask": _ns("nodes"),
    }
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=step_fn, args=(state, batch),
        in_shardings=(state_sh, batch_sh),
        donate_argnums=(0,),
        model_flops=_gnn_flops(n_sub, e_sub, f, cfg.d_hidden, c),
    )


def _gnn_molecule_cell(arch, cfg: GNNConfig, sp: ShapeSpec,
                       draw: _Draw) -> Cell:
    p = sp.p()
    b, nn, ne = p["batch"], p["n_nodes"], p["n_edges"]
    f, c = p["d_feat"], p["n_classes"]
    cfg = dataclasses.replace(cfg, n_classes=c)
    step_fn, state, state_sh = _gnn_state(cfg, f, gnn_molecule_loss_fn(cfg),
                                          draw)

    batch = {
        "feats": draw.normal((b, nn, f)),
        "src": draw.ints((b, ne), nn),
        "dst": draw.ints((b, ne), nn),
        "edge_w": draw.uniform((b, ne)),
        "labels": draw.ints((b,), c),
    }
    batch_sh = {
        "feats": _ns("batch", None, None),
        "src": _ns("batch", None),
        "dst": _ns("batch", None),
        "edge_w": _ns("batch", None),
        "labels": _ns("batch"),
    }
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=step_fn, args=(state, batch),
        in_shardings=(state_sh, batch_sh),
        donate_argnums=(0,),
        model_flops=b * _gnn_flops(nn, ne, f, cfg.d_hidden, c),
    )


# --------------------------------------------------------------------------
# RecSys cells
# --------------------------------------------------------------------------
def _recsys_init(cfg: RecSysConfig):
    return {
        "fm": R.fm_init, "dlrm": R.dlrm_init,
        "dien": R.dien_init, "bert4rec": R.bert4rec_init,
    }[cfg.model]


def _recsys_batch(cfg: RecSysConfig, b: int, draw: _Draw):
    if cfg.model == "fm":
        batch = {"ids": draw.ints((b, cfg.n_sparse), cfg.vocab_per_field),
                 "label": draw.coins((b,))}
        sh = {"ids": _ns("batch", None), "label": _ns("batch")}
    elif cfg.model == "dlrm":
        batch = {
            "ids": draw.ints((b, cfg.n_sparse), cfg.vocab_per_field),
            "dense": draw.normal((b, cfg.n_dense)),
            "label": draw.coins((b,)),
        }
        sh = {"ids": _ns("batch", None), "dense": _ns("batch", None),
              "label": _ns("batch")}
    elif cfg.model == "dien":
        batch = {
            "hist": draw.ints((b, cfg.seq_len), cfg.vocab_per_field),
            "target": draw.ints((b,), cfg.vocab_per_field),
            "label": draw.coins((b,)),
        }
        sh = {"hist": _ns("batch", None), "target": _ns("batch"),
              "label": _ns("batch")}
    else:  # bert4rec: items 1..n_items, the [MASK] id n_items + 1
        mask = draw.coins((b, cfg.seq_len), torch.int32, p=0.15)
        items = draw.ints((b, cfg.seq_len), cfg.n_items, lo=1)
        seq = (torch.empty_like(items) if draw.meta else torch.where(
            mask.bool(), cfg.n_items + 1, items).to(torch.int32))
        batch = {"seq": seq, "labels": items, "mask": mask}
        sh = {"seq": _ns("batch", None), "labels": _ns("batch", None),
              "mask": _ns("batch", None)}
    return batch, sh


def _recsys_flops(cfg: RecSysConfig, b: int, train: bool) -> float:
    mult = 3.0 if train else 1.0
    if cfg.model == "fm":
        return mult * 2.0 * b * cfg.n_sparse * cfg.embed_dim * 2
    if cfg.model == "dlrm":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        bot = sum(2 * a * bb for a, bb in zip(dims, dims[1:]))
        nf = cfg.n_sparse + 1
        inter = 2 * nf * nf * cfg.embed_dim
        tdims = (cfg.bot_mlp[-1] + nf * (nf - 1) // 2,) + cfg.top_mlp
        top = sum(2 * a * bb for a, bb in zip(tdims, tdims[1:]))
        return mult * b * (bot + inter + top)
    if cfg.model == "dien":
        gru = 2 * cfg.seq_len * 3 * (cfg.embed_dim + cfg.gru_dim) * cfg.gru_dim
        augru = 2 * cfg.seq_len * 3 * (2 * cfg.gru_dim) * cfg.gru_dim
        mdims = (cfg.gru_dim + 2 * cfg.embed_dim,) + cfg.mlp_dims + (1,)
        mlp = sum(2 * a * bb for a, bb in zip(mdims, mdims[1:]))
        return mult * b * (gru + augru + mlp)
    # bert4rec
    d, s = cfg.embed_dim, cfg.seq_len
    blk = 2 * s * (4 * d * d) + 4 * s * s * d + 2 * s * (8 * d * d)
    head = 2 * s * d * (cfg.n_items + 2)
    return mult * b * (cfg.n_blocks * blk + head)


def _recsys_train_cell(arch, cfg: RecSysConfig, sp: ShapeSpec,
                       draw: _Draw) -> Cell:
    b = sp.p()["batch"]
    opt = default_optimizer(cfg)
    init_fn, step_fn = make_train_step(recsys_loss_fn(cfg), opt)
    state = init_fn(_recsys_init(cfg)(draw.gen, cfg, draw.dev))
    specs = generic_param_specs(state.params)
    state_sh = _state_shardings(state, specs)
    batch, batch_sh = _recsys_batch(cfg, b, draw)
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=step_fn, args=(state, batch),
        in_shardings=(state_sh, batch_sh),
        donate_argnums=(0,),
        model_flops=_recsys_flops(cfg, b, train=True),
    )


def _recsys_serve_fn(params, batch, *, cfg):
    if cfg.model == "bert4rec":
        return R.bert4rec_logits(params, cfg, batch["seq"])
    score = {"fm": R.fm_score, "dlrm": R.dlrm_score, "dien": R.dien_score}[cfg.model]
    return score(params, cfg, batch)


def _recsys_serve_cell(arch, cfg: RecSysConfig, sp: ShapeSpec,
                       draw: _Draw) -> Cell:
    b = sp.p()["batch"]
    params = _recsys_init(cfg)(draw.gen, cfg, draw.dev).tree()
    specs = generic_param_specs(params)
    batch, batch_sh = _recsys_batch(cfg, b, draw)
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=partial(_recsys_serve_fn, cfg=cfg),
        args=(params, batch),
        in_shardings=(tree_named_shardings(specs), batch_sh),
        model_flops=_recsys_flops(cfg, b, train=False),
    )


def _recsys_retrieval_fn(params, batch, cand, *, cfg):
    uv = R.user_vector(params, cfg, batch)
    scores = R.retrieval_scores(uv, cand)
    return torch.topk(scores, 10)


def _recsys_retrieval_cell(arch, cfg: RecSysConfig, sp: ShapeSpec,
                           draw: _Draw) -> Cell:
    p = sp.p()
    b, nc = p["batch"], p["n_candidates"]
    nc = _pad_to(nc, max(axis_size("candidates"), 1))  # shardable pad
    params = _recsys_init(cfg)(draw.gen, cfg, draw.dev).tree()
    specs = generic_param_specs(params)
    batch, batch_sh = _recsys_batch(cfg, b, draw)
    batch.pop("label", None)
    batch_sh.pop("label", None)
    cand = draw.normal((nc, cfg.embed_dim))
    return Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=partial(_recsys_retrieval_fn, cfg=cfg),
        args=(params, batch, cand),
        in_shardings=(
            tree_named_shardings(specs), batch_sh, _ns("candidates", None)
        ),
        model_flops=2.0 * b * nc * cfg.embed_dim,
    )


# --------------------------------------------------------------------------
# PIR serve cells (the paper's own workload)
#
# Variants (hillclimb log in EXPERIMENTS.md §Perf; select via
# REPRO_PIR_VARIANT, default = fully-optimized "xorbfly"):
#   baseline : paper-faithful batched Chor — queries sharded over batch
#              axes, records over "model"; f32 operands; f32 product.
#   bf16     : the reference feeds the MXU bf16 (0/1 exact); here the
#              parity kernel on the uint8 operands (int8 tensor cores,
#              int32 sums: exact at every n).
#   reshard  : records sharded over ALL axes, queries replicated — DB read
#              per device drops |data|×; turns the step compute-bound.
#   xorbfly  : + GF(2) all-reduce: each position's partial parities,
#              packed to words by the kernel, combined by a
#              log2(shards)-round XOR butterfly (collectives.xor_psum).
# --------------------------------------------------------------------------
def _pir_variant() -> str:
    return _os.environ.get("REPRO_PIR_VARIANT", "xorbfly")


def _pir_serve_fn_baseline(masks, planes):
    acc = torch.matmul(masks.to(torch.float32), planes.to(torch.float32))
    bits = torch.remainder(acc, 2.0).to(torch.uint8)
    return packing.pack_bits(bits)


def _pir_serve_fn_bf16(masks, planes):
    # not a bf16 product: its output rounds to bf16, so a sum above 256
    # would lose its low bit, the parity (the reference keeps the sums in
    # f32, preferred_element_type)
    return parity_matmul_packed(masks, planes)


def _pir_serve_fn_xorbfly(masks, planes):
    """Per mesh position: the parity kernel on its block of the records,
    then the XOR butterfly over the record axes; every position ends with
    the answer, and position 0's is returned."""
    mesh = current_mesh()
    rec_axes = mesh_axis_names("records")
    shards = math.prod(mesh.shape[a] for a in rec_axes)
    n_loc = masks.shape[1] // shards
    parts = []
    for pos in mesh.positions():
        dev = mesh.device_at(pos)
        lo = mesh.block_of(pos, rec_axes) * n_loc
        parts.append(parity_matmul_packed(
            masks[:, lo:lo + n_loc].to(dev), planes[lo:lo + n_loc].to(dev)))
    return collectives.xor_psum(parts, mesh, rec_axes)[0]


def pir_store_words(cfg: PIRConfig, n_pad: int, device: DeviceLike = None,
                    seed: int = 0) -> torch.Tensor:
    """The packed ``[n_pad, record_bytes / 4]`` words whose bit planes a
    PIR cell built from ``seed`` on ``device`` serves: random records,
    the padding rows zero. The same call gives the same words."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = packing.words_per_record(cfg.record_bytes * 8)
    words = torch.zeros((n_pad, w), dtype=packing.WORD_DTYPE, device=dev)
    words[:cfg.n_records] = torch.randint(
        -(2**31), 2**31, (cfg.n_records, w), generator=gen, device=dev,
        dtype=torch.int64).to(packing.WORD_DTYPE)
    return words


def _planes_rows(words: torch.Tensor) -> torch.Tensor:
    """[n, W] words -> [n, 32·W] uint8 planes in rows (the reference's
    layout; a row block of it is one contiguous block)."""
    n, w = words.shape
    planes = torch.empty((n, w * packing.WORD_BITS), dtype=torch.uint8,
                         device=words.device)
    step = 1 << 15
    for lo in range(0, n, step):
        planes[lo:lo + step] = packing.unpack_bits(words[lo:lo + step])
    return planes


def _pir_cell(arch, cfg: PIRConfig, sp: ShapeSpec, draw: _Draw,
              seed: int) -> Cell:
    q = sp.p()["query_batch"]
    n = cfg.n_records
    bits = cfg.record_bytes * 8
    variant = _pir_variant()
    if variant in ("reshard", "xorbfly"):
        n = _pad_to(n, max(axis_size("records"), 1))  # shardable pad (zeros)
    if draw.meta:
        planes = torch.empty((n, bits), dtype=torch.uint8, device=draw.dev)
    else:
        planes = _planes_rows(pir_store_words(cfg, n, draw.dev, seed))
    masks = draw.coins((q, n), torch.uint8)

    if variant == "baseline":
        fn, in_sh = _pir_serve_fn_baseline, (
            _ns("queries", "records"), _ns("records", None))
    elif variant == "bf16":
        fn, in_sh = _pir_serve_fn_bf16, (
            _ns("queries", "records"), _ns("records", None))
    elif variant == "reshard":
        fn, in_sh = _pir_serve_fn_bf16, (
            _ns(None, "records"), _ns("records", None))
    else:  # xorbfly
        fn, in_sh = _pir_serve_fn_xorbfly, (
            _ns(None, "records"), _ns("records", None))

    cell = Cell(
        arch=arch, shape=sp.name, kind=sp.kind,
        fn=fn,
        args=(masks, planes),
        in_shardings=in_sh,
        model_flops=2.0 * q * n * bits,
    )
    return cell


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def rules_for_cell(sp: ShapeSpec, multi_pod: bool = False) -> Dict:
    """Per-cell logical-rule overrides, merged into the mesh rules by the
    dry run BEFORE build_cell (shardings are resolved eagerly under them)."""
    if sp.kind == "lm_long_decode":
        # batch=1: nothing to shard on data; spread KV over data AND model
        return {"batch": None, "kv_seq": ("data", "model")}
    if sp.kind == "gnn_batched":
        # tiny graphs under vmap: aggregation must NOT take shard_map path
        return {"nodes": None, "edges": None}
    if sp.kind == "recsys_retrieval":
        return {"batch": None}  # batch=1
    if sp.kind == "pir_serve" and _pir_variant() in ("reshard", "xorbfly"):
        # records over EVERY axis: DB read per device drops |data|(·|pod|)×
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {"records": axes, "queries": None}
    if sp.kind == "lm_train" and _lm_variant() in ("fsdp", "fsdp_dots"):
        # pure ZeRO-3: batch/FSDP over EVERY axis, no TP, no SP
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {
            "batch": axes, "fsdp": axes, "heads": None, "kv_heads": None,
            "ff": None, "vocab": None, "seq_res": None, "experts": None,
        }
    return {}


def build_cell(arch_id: str, sp: ShapeSpec, *, device: DeviceLike = None,
               seed: int = 0, cfg=None) -> Cell:
    """The cell of ``arch_id`` at shape ``sp`` with its arguments on
    ``device`` (``None``: the card, an error without one; ``"meta"``: the
    dry run's shapes only; ``"cpu"``: the tests), parameters and values
    drawn from ``seed``. ``cfg`` replaces the arch's ``CONFIG`` (a cut
    configuration of the same family, e.g. its ``reduced()``)."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_arch(arch_id).CONFIG
    draw = _Draw(dev, seed)
    kind = sp.kind
    if kind == "lm_train":
        return _lm_train_cell(arch_id, cfg, sp, draw)
    if kind == "lm_prefill":
        return _lm_prefill_cell(arch_id, cfg, sp, draw)
    if kind == "lm_decode":
        return _lm_decode_cell(arch_id, cfg, sp, False, draw)
    if kind == "lm_long_decode":
        return _lm_decode_cell(arch_id, cfg, sp, True, draw)
    if kind == "gnn_full":
        return _gnn_full_cell(arch_id, cfg, sp, draw)
    if kind == "gnn_minibatch":
        return _gnn_minibatch_cell(arch_id, cfg, sp, draw)
    if kind == "gnn_batched":
        return _gnn_molecule_cell(arch_id, cfg, sp, draw)
    if kind == "recsys_train":
        return _recsys_train_cell(arch_id, cfg, sp, draw)
    if kind == "recsys_serve":
        return _recsys_serve_cell(arch_id, cfg, sp, draw)
    if kind == "recsys_retrieval":
        return _recsys_retrieval_cell(arch_id, cfg, sp, draw)
    if kind == "pir_serve":
        return _pir_cell(arch_id, cfg, sp, draw, seed)
    raise ValueError(f"unknown cell kind {kind!r}")


_DISPATCH = build_cell


def build_cell_sanitized(arch_id: str, sp: ShapeSpec, **kw) -> Cell:
    cell = _DISPATCH(arch_id, sp, **kw)
    if cell.in_shardings is not None:
        cell.in_shardings = tuple(
            _sanitize_shardings(sh, arg)
            for sh, arg in zip(cell.in_shardings, cell.args)
        )
    return cell


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_to(v, device) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def cell_to_device(cell: Cell, device: DeviceLike = None) -> Cell:
    """The same cell with its arguments (weights and inputs) copied to
    ``device`` (``None``: the card): the card-against-CPU check runs one
    cell's values on both."""
    return dataclasses.replace(cell, args=_to(cell.args,
                                              resolve_device(device)))
