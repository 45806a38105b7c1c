"""State carried across packages: stores, wire payloads and model weights
as numpy.

Data takes the place of weights in the PIR system; the models beside it
have weights too. These functions take and return **numpy arrays only**
(single-index and jagged multi-index wire batches, and parameter trees as
nested dicts and lists of arrays), so this package never imports the
reference package: a caller that holds the reference's store, ``Queries``
or parameter pytree moves them through numpy, and both packages then
compute on the same bits.

bfloat16 weights: numpy has no bfloat16 of its own. An array whose dtype
is named ``bfloat16`` (what ``np.asarray`` of a JAX bf16 array gives) is
read bit for bit; ``*_to_numpy`` gives bf16 tensors back as float32 (a
widening that loses no bit).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.protocol import MultiQueries, Queries
from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.models import gnn, layers, recsys, transformer

__all__ = [
    "store_from_numpy",
    "store_to_numpy",
    "queries_from_numpy",
    "queries_to_numpy",
    "multi_queries_from_numpy",
    "multi_queries_to_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "bert4rec_params_from_numpy",
    "bert4rec_params_to_numpy",
    "recsys_params_from_numpy",
    "recsys_params_to_numpy",
    "gcn_params_from_numpy",
    "gcn_params_to_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
]


def _owned(a, dtype) -> np.ndarray:
    """A C-contiguous array torch may alias (read-only inputs are copied)."""
    # (ascontiguousarray makes a 0-d array 1-d: keep the shape)
    arr = np.ascontiguousarray(a, dtype=dtype).reshape(np.shape(a))
    return arr if arr.flags.writeable else arr.copy()


def store_from_numpy(
    packed_u32: np.ndarray, record_bits: int, device: DeviceLike = None
) -> RecordStore:
    """[n, W] uint32 packed words + the record width -> a store on
    ``device`` (``None``: the CUDA card)."""
    packed_u32 = np.asarray(packed_u32)
    if packed_u32.ndim != 2 or packed_u32.dtype != np.uint32:
        raise ValueError("packed_u32 must be a [n, W] uint32 array")
    if packing.words_per_record(record_bits) != packed_u32.shape[1]:
        raise ValueError(
            f"record_bits={record_bits} does not match W={packed_u32.shape[1]}"
        )
    dev = resolve_device(device)
    return RecordStore(
        packed=packing.words_from_numpy(packed_u32, dev),
        record_bits=int(record_bits),
    )


def store_to_numpy(store: RecordStore) -> Tuple[np.ndarray, int]:
    """A store -> ([n, W] uint32 packed words, record_bits)."""
    return packing.words_to_numpy(store.packed), store.record_bits


def queries_from_numpy(
    kind: str,
    payload: np.ndarray,
    servers: Sequence[int],
    q_idx: np.ndarray,
    theta: Optional[float] = None,
    device: DeviceLike = None,
    store_version: Optional[int] = None,
) -> Queries:
    """A wire payload ([d, B, n] {0,1} masks for the ``mask`` kind,
    [d, B, p/d] record indices for the ``index`` kind) -> :class:`Queries`
    on ``device``."""
    dev = resolve_device(device)
    if kind == "mask":
        arr = _owned(payload, np.uint8)
    elif kind == "index":
        arr = _owned(payload, np.int32)
    else:
        raise ValueError(f"unknown wire kind {kind!r}")
    if arr.ndim != 3:
        raise ValueError(f"a {kind} payload is [d, B, ...] (3-d)")
    return Queries(
        kind=kind,
        payload=torch.from_numpy(arr).to(dev),
        servers=tuple(int(s) for s in servers),
        q_idx=torch.from_numpy(_owned(q_idx, np.int32)).to(dev),
        theta=None if theta is None else float(theta),
        store_version=None if store_version is None else int(store_version),
    )


def queries_to_numpy(q: Queries) -> dict:
    """:class:`Queries` -> plain numpy/python fields (the inverse of
    :func:`queries_from_numpy`'s arguments)."""
    return {
        "kind": q.kind,
        "payload": q.payload.detach().cpu().numpy(),
        "servers": tuple(q.servers),
        "q_idx": q.q_idx.detach().cpu().numpy(),
        "theta": q.theta,
        "store_version": q.store_version,
    }


def multi_queries_from_numpy(
    kind: str,
    payload: np.ndarray,
    servers: Sequence[int],
    q_idx: np.ndarray,
    offsets: np.ndarray,
    k_max: int,
    requests: int,
    theta: Optional[float] = None,
    device: DeviceLike = None,
    store_version: Optional[int] = None,
) -> MultiQueries:
    """A jagged multi-index wire batch (the flat payload, its flat
    ``q_idx`` and the jagged descriptor) -> :class:`MultiQueries` on
    ``device``."""
    flat = queries_from_numpy(
        kind, payload, servers, q_idx, theta, device=device,
        store_version=store_version,
    )
    offsets = np.asarray(offsets, dtype=np.int32)
    if offsets.ndim != 1 or offsets.shape[0] != int(requests) + 1:
        raise ValueError("offsets must be [requests + 1]")
    if flat.payload.shape[1] % int(k_max):
        raise ValueError(
            f"flat bucket {flat.payload.shape[1]} not a multiple of "
            f"k_max={k_max}"
        )
    return MultiQueries(
        queries=flat, offsets=offsets.copy(), k_max=int(k_max),
        requests=int(requests),
    )


def multi_queries_to_numpy(mq: MultiQueries) -> dict:
    """:class:`MultiQueries` -> plain numpy/python fields (the inverse of
    :func:`multi_queries_from_numpy`'s arguments)."""
    return {
        **queries_to_numpy(mq.queries),
        "offsets": np.asarray(mq.offsets, dtype=np.int32),
        "k_max": int(mq.k_max),
        "requests": int(mq.requests),
    }


# ------------------------------------------------------------ model weights
def _tensor_from_numpy(a, device: torch.device,
                       dtype: Optional[torch.dtype]) -> torch.Tensor:
    """An array as a tensor on ``device`` in ``dtype`` (``None``: its own).
    A bf16 array is read bit for bit: one of numpy's ``bfloat16`` type, or
    the 2-byte void numpy reads back from a file of one."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(_owned(arr.view(np.uint16), np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(_owned(arr, arr.dtype))
    return t.to(device=device, dtype=dtype)


def _tree_from_numpy(tree: Any, device: torch.device, dtype: torch.dtype,
                     f32_leaves: Tuple[str, ...] = ()):
    """Every leaf in ``dtype``, but those named in ``f32_leaves``, which
    stay float32 whatever the model's dtype (the MoE router)."""
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(
                    v, device, torch.float32 if k in f32_leaves else dtype,
                    f32_leaves)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device, dtype, f32_leaves) for v in tree]
    return _tensor_from_numpy(tree, device, dtype)


def _tree_to_numpy(tree: Any):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def lm_params_from_numpy(
    tree: dict, cfg, device: DeviceLike = None
) -> "transformer.TransformerLM":
    """The reference's ``init_lm`` pytree as numpy (``embed``, stacked
    ``layers``, ``final_norm``; dense or MoE) -> a :class:`TransformerLM`
    on ``device`` (``None``: the card), in the config's dtype but the MoE
    ``router``, which stays float32 as the reference keeps it."""
    if np.shape(tree["embed"]) != (cfg.vocab, cfg.d_model):
        raise ValueError(
            f"embed is {np.shape(tree['embed'])}, the config wants "
            f"{(cfg.vocab, cfg.d_model)}"
        )
    dev = resolve_device(device)
    return transformer.TransformerLM(
        _tree_from_numpy(tree, dev, transformer._dtype(cfg),
                         f32_leaves=("router",)), cfg
    )


def lm_params_to_numpy(params) -> dict:
    """A :class:`TransformerLM` (or its tree) -> the reference's pytree
    layout as numpy."""
    return _tree_to_numpy(layers.as_tree(params))


def bert4rec_params_from_numpy(
    tree: dict, cfg, device: DeviceLike = None
) -> "recsys.BERT4Rec":
    """The reference's ``bert4rec_init`` pytree as numpy (``embed``,
    ``pos``, the list ``blocks``, ``final_ln``) -> a :class:`BERT4Rec` on
    ``device`` (``None``: the card), float32."""
    if np.shape(tree["embed"]) != (recsys.bert4rec_vocab(cfg), cfg.embed_dim):
        raise ValueError(f"embed is {np.shape(tree['embed'])}, not the "
                         "config's vocab x embed_dim")
    dev = resolve_device(device)
    return recsys.BERT4Rec(_tree_from_numpy(tree, dev, torch.float32), cfg)


def bert4rec_params_to_numpy(params) -> dict:
    """A :class:`BERT4Rec` (or its tree) -> the reference's pytree layout
    as numpy."""
    return _tree_to_numpy(layers.as_tree(params))


def _check_shapes(tree: Any, spec: Any, what: str, path: str = "") -> None:
    """Every leaf of ``tree`` has the shape its :class:`~repro_torch.models.
    layers.Leaf` in ``spec`` gives, and the two have the same keys."""
    if isinstance(spec, layers.Leaf):
        if tuple(np.shape(tree)) != tuple(spec.shape):
            raise ValueError(f"{what}: {path or 'leaf'} is {np.shape(tree)}, "
                             f"the config wants {tuple(spec.shape)}")
        return
    if not isinstance(tree, dict) or set(tree) != set(spec):
        raise ValueError(f"{what}: {path or 'the tree'} has keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree!r}"
                         f", the config wants {sorted(spec)}")
    for k, v in spec.items():
        _check_shapes(tree[k], v, what, f"{path}/{k}" if path else k)


_RECSYS = {"fm": (recsys.fm_spec, recsys.FM),
           "dlrm": (recsys.dlrm_spec, recsys.DLRM),
           "dien": (recsys.dien_spec, recsys.DIEN)}


def recsys_params_from_numpy(tree: dict, cfg, device: DeviceLike = None):
    """The reference's ``fm_init``/``dlrm_init``/``dien_init`` pytree as
    numpy -> an :class:`~repro_torch.models.recsys.FM`, ``DLRM`` or
    ``DIEN`` (by ``cfg.model``) on ``device`` (``None``: the card),
    float32, every leaf's shape checked against the config."""
    if cfg.model not in _RECSYS:
        raise ValueError(f"no FM/DLRM/DIEN layout for model {cfg.model!r}")
    spec, cls = _RECSYS[cfg.model]
    _check_shapes(tree, spec(cfg), cfg.name)
    return cls(_tree_from_numpy(tree, resolve_device(device), torch.float32),
               cfg)


def recsys_params_to_numpy(params) -> dict:
    """An FM, DLRM or DIEN (or its tree) -> the reference's pytree layout
    as numpy."""
    return _tree_to_numpy(layers.as_tree(params))


def gcn_params_from_numpy(tree: dict, cfg, device: DeviceLike = None
                          ) -> "gnn.GCN":
    """The reference's ``gcn_init`` pytree as numpy (``w0`` ... each
    ``{"w": [d_in, d_out]}``) -> a :class:`~repro_torch.models.gnn.GCN` on
    ``device`` (``None``: the card), float32; the layers' shapes are
    checked against the config (the input width is ``w0``'s)."""
    d_feat = int(np.shape(tree["w0"]["w"])[0])
    _check_shapes(tree, gnn.gcn_spec(cfg, d_feat), cfg.name)
    return gnn.GCN(_tree_from_numpy(tree, resolve_device(device),
                                    torch.float32), cfg)


def gcn_params_to_numpy(params) -> dict:
    """A :class:`~repro_torch.models.gnn.GCN` (or its tree) -> the
    reference's pytree layout as numpy."""
    return _tree_to_numpy(layers.as_tree(params))


# ------------------------------------------------------------ training state
def train_state_from_numpy(state, cfg=None, device: DeviceLike = None):
    """A training state as numpy (the reference's ``TrainState`` with
    numpy leaves, or a dict of its four fields: ``params``, ``opt_state``,
    ``comp_state``, ``step``) -> the port's
    :class:`~repro_torch.train.TrainState` on ``device`` (``None``: the
    card).

    The parameters take an LM config's dtype (the MoE ``router`` float32)
    when ``cfg`` is an LM config, else float32; the optimizer's and the
    compressor's states (AdamW's ``m``, ``v``, ``step``; Adafactor's
    ``row``/``col``/``v``; the compressor's ``err``) and the step keep
    their own dtypes (float32 and int32 in both packages)."""
    from repro_torch.configs.base import LMConfig
    from repro_torch.train.train_step import TrainState

    if hasattr(state, "_asdict"):
        state = state._asdict()
    dev = resolve_device(device)
    if isinstance(cfg, LMConfig):
        params = _tree_from_numpy(state["params"], dev,
                                  transformer._dtype(cfg),
                                  f32_leaves=("router",))
    else:
        params = _tree_from_numpy(state["params"], dev, torch.float32)
    return TrainState(
        params=params,
        opt_state=_tree_from_numpy(state["opt_state"], dev, None),
        comp_state=_tree_from_numpy(state["comp_state"], dev, None),
        step=_tree_from_numpy(state["step"], dev, None),
    )


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` -> a dict of its four fields as numpy
    (bf16 leaves as float32)."""
    return {k: _tree_to_numpy(v) for k, v in state._asdict().items()}
