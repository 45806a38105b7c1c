"""Parameter sharding specs: trees of partition specs mirroring param trees.

Specs are resolved from the *logical* rule table when they are asked for
(so the same code yields Megatron TP×FSDP under ``DEFAULT_RULES`` and pure
ZeRO-3 under an fsdp override), but the returned leaves are plain
mesh-axis :class:`~repro_torch.dist.sharding.P` specs, keyed like the
reference package's.

The port's parameter trees are nested dicts and lists of tensors (a
:class:`~repro_torch.models.layers.ParamTree` gives its ``tree()``), with
the reference's layout and names, so a leaf's path ("layers/wq/w") is the
reference's.

Conventions (baseline rules):

  LM (lm_param_specs — keyed on the init_lm tree layout):
    embed [V, D]               -> ("vocab", "fsdp")   vocab-sharded, tied
    layers/wq|wk|wv/w [L,D,H]  -> (None, "fsdp", "heads"/"kv_heads")
    layers/wo/w [L,H,D]        -> (None, "heads", "fsdp")
    layers/mlp/wi|wg/w [L,D,F] -> (None, "fsdp", "ff")
    layers/mlp/wo/w [L,F,D]    -> (None, "ff", "fsdp")
    layers/moe/w_gate|w_in     -> (None, "experts", "fsdp", None)
    layers/moe/w_out           -> (None, "experts", None, "fsdp")
    norms / router / scalars   -> replicated

  Generic (generic_param_specs — RecSys/GNN trees): any rank-≥2 leaf with
  ≥ TABLE_ROWS_THRESHOLD rows is treated as an embedding table and
  row-sharded over "table_vocab"; other rank-≥2 leaves FSDP-shard their
  leading dim; vectors/scalars replicate.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.dist.sharding import P, current_mesh, logical_to_spec

__all__ = [
    "TABLE_ROWS_THRESHOLD",
    "generic_param_specs",
    "lm_param_specs",
    "tree_named_shardings",
]

TABLE_ROWS_THRESHOLD = 4096


def _as_tree(params: Any) -> Any:
    # a ParamTree (or a model built on one) -> its nested dict
    return params.tree() if hasattr(params, "tree") else params


def _map_with_paths(tree: Any, fn: Callable[[str, Any], Any],
                    prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict/list tree, same structure."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------
def _lm_leaf_spec(path: str, leaf) -> P:
    seg = path.split("/")
    ndim = getattr(leaf, "ndim", 0)
    if seg[0] == "embed":
        return logical_to_spec("vocab", "fsdp")
    if seg[-1] in ("scale", "bias") or "router" in seg or ndim < 2:
        return P()
    if "w_gate" in seg or "w_in" in seg:          # [L, E, D, F]
        return logical_to_spec(None, "experts", "fsdp", None)
    if "w_out" in seg:                            # [L, E, F, D]
        return logical_to_spec(None, "experts", None, "fsdp")
    if "wq" in seg:                               # [L, D, Hq·dh]
        return logical_to_spec(None, "fsdp", "heads")
    if "wk" in seg or "wv" in seg:                # [L, D, Hkv·dh]
        return logical_to_spec(None, "fsdp", "kv_heads")
    if "mlp" in seg and "wo" in seg:              # [L, F, D]
        return logical_to_spec(None, "ff", "fsdp")
    if "wo" in seg:                               # attn out [L, Hq·dh, D]
        return logical_to_spec(None, "heads", "fsdp")
    if "wi" in seg or "wg" in seg:                # [L, D, F]
        return logical_to_spec(None, "fsdp", "ff")
    return P()


def lm_param_specs(params: Any) -> Any:
    """Spec tree for an init_lm parameter tree (TP×FSDP×SP)."""
    return _map_with_paths(_as_tree(params), _lm_leaf_spec)


# --------------------------------------------------------------------------
# Generic (RecSys / GNN / anything without a bespoke layout)
# --------------------------------------------------------------------------
def _generic_leaf_spec(path: str, leaf) -> P:
    ndim = getattr(leaf, "ndim", 0)
    if ndim < 2:
        return P()
    if leaf.shape[0] >= TABLE_ROWS_THRESHOLD:     # embedding table rows
        return logical_to_spec("table_vocab", *([None] * (ndim - 1)))
    return logical_to_spec("fsdp", *([None] * (ndim - 1)))


def generic_param_specs(params: Any) -> Any:
    return _map_with_paths(_as_tree(params), _generic_leaf_spec)


# --------------------------------------------------------------------------
# Specs -> (mesh, spec) pairs on the active mesh
# --------------------------------------------------------------------------
def tree_named_shardings(spec_tree: Any) -> Any:
    """Each spec leaf -> ``(mesh, spec)`` on the active mesh (the
    reference's ``NamedSharding``; :func:`~repro_torch.dist.sharding.device_put`
    takes the pair's parts). Raises without an active mesh."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("tree_named_shardings requires a mesh_rules context")

    def walk(t):
        if isinstance(t, P):
            return (mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    return walk(spec_tree)
