"""Private BERT4Rec on the CPU against the JAX package: the encoder and
its logits with the reference's weights (carried across by
``repro_torch.convert``) on the reference's item sequences, then with the
item lookups fetched through ``PrivateEmbedding`` (Sparse-PIR, d = 4,
d_a = 2), which must give the plain-lookup logits bit for bit. Also the
float-table store and ``PrivateEmbedding``'s budget, mirroring
tests/test_private_models.py.

Tolerance: 1e-5 against the reference (f32; the packages' CPU kernels sum
in other orders); 0 between the private and the plain port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import PrivateEmbedding as RefPrivateEmbedding
from repro.data import pipeline as ref_pipeline
from repro.db.store import RecordStore as RefRecordStore
from repro.models import recsys as RR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import PrivateEmbedding, make_scheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.data import bert4rec_batch
from repro_torch.db import packing
from repro_torch.db.store import RecordStore
from repro_torch.models import recsys as R

from _torch_parity import CPU, words_t2n

TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def bert4rec():
    ref_cfg = ref_get_arch("bert4rec").reduced()
    cfg = get_arch("bert4rec").reduced()
    params = RR.bert4rec_init(jax.random.key(0), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.bert4rec_params_from_numpy(tree, cfg, device=CPU)
    batch = bert4rec_batch(cfg, 3, seed=0, step=0)
    return ref_cfg, cfg, params, tree, model, batch


def test_batch_and_vocab_equal_the_reference(bert4rec):
    ref_cfg, cfg, _, _, _, batch = bert4rec
    want = ref_pipeline.bert4rec_batch(ref_cfg, 3, seed=0, step=0)
    for key in ("seq", "labels", "mask"):
        np.testing.assert_array_equal(batch[key], want[key])
    for c, rc in ((cfg, ref_cfg), (get_arch("bert4rec").CONFIG,
                                   ref_get_arch("bert4rec").CONFIG)):
        assert R.bert4rec_vocab(c) == RR.bert4rec_vocab(rc)


def test_weights_round_trip_and_init_has_the_reference_layout(bert4rec):
    _, cfg, params, tree, model, _ = bert4rec
    back = convert.bert4rec_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
    mine = R.bert4rec_init(_gen(0), cfg, device=CPU)
    assert isinstance(mine, R.BERT4Rec)
    assert jax.tree.map(lambda t: tuple(t.shape), mine.tree()) == \
        jax.tree.map(lambda a: tuple(a.shape), params)


def test_hidden_and_logits_match_the_reference(bert4rec):
    ref_cfg, cfg, params, _, model, batch = bert4rec
    seq = batch["seq"]
    np.testing.assert_allclose(
        R.bert4rec_hidden(model, cfg, seq).numpy(),
        np.asarray(RR.bert4rec_hidden(params, ref_cfg, jnp.asarray(seq))), **TOL)
    logits = R.bert4rec_logits(model, cfg, seq)
    assert logits.shape == (3, R.bert4rec_vocab(cfg))
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(RR.bert4rec_logits(params, ref_cfg, jnp.asarray(seq))), **TOL)


@pytest.mark.parametrize("scheme,kw", [("sparse", dict(theta=0.25)), ("chor", {})])
def test_private_lookups_give_the_plain_logits_bit_for_bit(bert4rec, scheme, kw):
    _, cfg, _, _, model, batch = bert4rec
    plain = R.bert4rec_logits(model, cfg, batch["seq"])
    pe = PrivateEmbedding.create(model.tree()["embed"], scheme=scheme, d=4,
                                 d_a=2, **kw)
    gen = _gen(1)
    private = R.bert4rec_logits(model, cfg, batch["seq"],
                                lookup_fn=lambda table, ids: pe.lookup(gen, ids))
    np.testing.assert_array_equal(private.numpy(), plain.numpy())


def test_config_fields_drive_the_private_lookup(bert4rec):
    _, cfg, _, _, model, _ = bert4rec
    pe = PrivateEmbedding.create(
        model.tree()["embed"], scheme="sparse", d=cfg.private_lookup_d,
        d_a=cfg.private_lookup_da, theta=cfg.private_lookup_theta)
    ref = RefPrivateEmbedding.create(
        jnp.asarray(convert.bert4rec_params_to_numpy(model)["embed"]),
        scheme="sparse", d=cfg.private_lookup_d, d_a=cfg.private_lookup_da,
        theta=cfg.private_lookup_theta)
    assert pe.epsilon_per_lookup() == ref.epsilon_per_lookup()
    assert pe.delta_per_lookup() == ref.delta_per_lookup()
    assert pe.server_cost() == ref.server_cost()
    assert (pe.vocab, pe.dim) == (ref.vocab, ref.dim)


def test_private_embedding_budget_and_bags():
    tbl = torch.from_numpy(
        np.random.default_rng(1).standard_normal((128, 8)).astype(np.float32))
    budget = PrivacyBudget(epsilon_limit=100.0)
    pe = PrivateEmbedding.create(tbl, scheme="sparse", d=4, d_a=2, theta=0.25,
                                 budget=budget)
    idx = torch.tensor([0, 5, 99, 127])
    out = pe.lookup(_gen(2), idx)
    np.testing.assert_array_equal(out.numpy(), tbl.numpy()[idx.numpy()])
    assert budget.spent_epsilon == pytest.approx(4 * pe.epsilon_per_lookup())

    # EmbeddingBag over PIR (gather + segment-reduce, mean combiner)
    flat = torch.tensor([1, 2, 3, 4, 5])
    seg = torch.tensor([0, 0, 1, 1, 1])
    bags = pe.bag_lookup(_gen(3), flat, seg, num_bags=2, combiner="mean")
    np.testing.assert_allclose(bags[0].numpy(), tbl.numpy()[[1, 2]].mean(0), rtol=1e-6)
    np.testing.assert_allclose(bags[1].numpy(), tbl.numpy()[[3, 4, 5]].mean(0), rtol=1e-6)
    sums = pe.bag_lookup(_gen(4), flat, seg, num_bags=2)
    np.testing.assert_allclose(sums[1].numpy(), tbl.numpy()[[3, 4, 5]].sum(0), rtol=1e-6)
    assert budget.spent_epsilon == pytest.approx(14 * pe.epsilon_per_lookup())
    # an unknown combiner is refused before anything is spent
    with pytest.raises(ValueError, match="combiner"):
        pe.bag_lookup(_gen(5), flat, seg, num_bags=2, combiner="max")
    assert budget.spent_epsilon == pytest.approx(14 * pe.epsilon_per_lookup())


def test_private_embedding_budget_exhaustion():
    pe = PrivateEmbedding.create(
        torch.ones((64, 4)), scheme="sparse", d=4, d_a=2, theta=0.25,
        budget=PrivacyBudget(epsilon_limit=1e-6),
    )
    with pytest.raises(PermissionError):
        pe.lookup(_gen(0), torch.tensor([1]))


def test_lookup_many_and_the_plain_mode():
    tbl = torch.from_numpy(
        np.random.default_rng(5).standard_normal((50, 6)).astype(np.float32))
    budget = PrivacyBudget(epsilon_limit=1e3)
    pe = PrivateEmbedding.create(tbl, scheme=make_scheme("sparse", 3, 1, theta=0.3),
                                 budget=budget)
    lists = [[3, 7, 7], [49], []]
    rows = pe.lookup_many(_gen(6), lists)
    for got, ix in zip(rows, lists):
        np.testing.assert_array_equal(got.numpy(), tbl.numpy()[ix].reshape(-1, 6))
    assert budget.spent_epsilon == pytest.approx(4 * pe.epsilon_per_lookup())
    plain = PrivateEmbedding.create(tbl)
    assert plain.epsilon_per_lookup() == 0.0
    assert plain.server_cost() == {"C_m": 1.0, "C_p": 1.0}
    np.testing.assert_array_equal(plain.lookup(None, [[2, 4]]).numpy(),
                                  tbl.numpy()[[[2, 4]]])
    with pytest.raises(ValueError):
        PrivateEmbedding(torch.ones((4, 4), dtype=torch.float64))


def test_float_table_store_carries_the_reference_bits():
    table = np.random.default_rng(7).standard_normal((33, 5)).astype(np.float32)
    table[0, :3] = (-0.0, np.inf, np.nan)
    store = RecordStore.from_float_table(torch.from_numpy(table))
    ref = RefRecordStore.from_float_table(jnp.asarray(table))
    assert store.record_bits == ref.record_bits == 5 * 32
    np.testing.assert_array_equal(words_t2n(store.packed), np.asarray(ref.packed))
    np.testing.assert_array_equal(store.as_float_table().numpy().view(np.uint32),
                                  table.view(np.uint32))
    np.testing.assert_array_equal(store.record_bytes(4), ref.record_bytes(4))
    words = packing.bitcast_f32_to_u32(torch.from_numpy(table))
    assert words.dtype == packing.WORD_DTYPE
    np.testing.assert_array_equal(
        packing.bitcast_u32_to_f32(words).numpy().view(np.uint32),
        table.view(np.uint32))
    with pytest.raises(TypeError):
        packing.bitcast_f32_to_u32(torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        RecordStore(packed=store.packed[:, :1], record_bits=20).as_float_table()
