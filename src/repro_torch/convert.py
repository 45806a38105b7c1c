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
from repro_torch.models import layers, recsys, transformer

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
]


def _owned(a, dtype) -> np.ndarray:
    """A C-contiguous array torch may alias (read-only inputs are copied)."""
    arr = np.ascontiguousarray(a, dtype=dtype)
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
def _tensor_from_numpy(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(_owned(arr.view(np.uint16), np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(_owned(arr, arr.dtype))
    return t.to(device=device, dtype=dtype)


def _tree_from_numpy(tree: Any, device: torch.device, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, device, dtype) for v in tree]
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
    ``layers``, ``final_norm``) -> a :class:`TransformerLM` on ``device``
    (``None``: the card), in the config's dtype."""
    if np.shape(tree["embed"]) != (cfg.vocab, cfg.d_model):
        raise ValueError(
            f"embed is {np.shape(tree['embed'])}, the config wants "
            f"{(cfg.vocab, cfg.d_model)}"
        )
    dev = resolve_device(device)
    return transformer.TransformerLM(
        _tree_from_numpy(tree, dev, transformer._dtype(cfg)), cfg
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
