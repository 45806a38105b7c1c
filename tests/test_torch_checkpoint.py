"""The port's checkpoints and its training launcher on the CPU: the
``CheckpointManager`` (atomic, keep-last-k, async), its on-disk layout
against the JAX package's (a checkpoint either package writes restores in
the other with equal arrays), a resumed run against an unbroken one, and
``launch/train.py`` (runs, saves, resumes; without ``--device`` and with
no card it raises).

Tolerance: 0 throughout (arrays round-trip bit for bit, and the CPU's
steps are deterministic, so a resumed run equals an unbroken one)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as RT
from repro.train import AdamW as RefAdamW
from repro.train import Adafactor as RefAdafactor
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import ErrorFeedbackCompressor as RefCompressor
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import lm_loss_fn as ref_lm_loss_fn
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train import (
    AdamW, Adafactor, CheckpointManager, ErrorFeedbackCompressor,
    TrainState, make_train_step,
)
from repro_torch.train.checkpoint import _flatten_with_paths
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import lm_loss_fn

from _torch_parity import CPU


def _cfg():
    return get_arch("smollm-135m").reduced()


def _state(cfg, opt=None, comp=None, seed=0):
    params = T.init_lm(torch.Generator().manual_seed(seed), cfg, device=CPU)
    init_fn, step_fn = make_train_step(lm_loss_fn(cfg), opt or AdamW(lr=1e-3),
                                       comp)
    return init_fn(params), step_fn


def _run(step_fn, state, cfg, lo, hi, batch=4, seq=16):
    losses = []
    for i in range(lo, hi):
        b = {"tokens": lm_batch(cfg, batch, seq, 0, i)["tokens"]}
        state, m = step_fn(state, b)
        losses.append(m["loss"].item())
    return state, losses


def _equal_states(a, b):
    """Leaf for leaf by path: the same dtype, device and bits."""
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert sorted(la) == sorted(lb)
    for k, x in la.items():
        y = lb[k]
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


def test_checkpoints_are_atomic_kept_k_and_async(tmp_path):
    cfg = _cfg()
    state, step_fn = _state(cfg)
    state, _ = _run(step_fn, state, cfg, 0, 2)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, extra={"seed": 0}, blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]  # GC kept the last 2
    assert mgr.latest_step() == 4
    assert not [x for x in os.listdir(tmp_path) if x.startswith("tmp-")]
    names = sorted(os.listdir(tmp_path / "step-0000000004"))
    assert "manifest.json" in names
    assert "params__layers__wq__w.npy" in names
    assert "opt_state__m__embed.npy" in names and "step.npy" in names
    template, _ = _state(cfg, seed=9)
    restored, man = mgr.restore(template)
    assert man["step"] == 4 and man["extra"] == {"seed": 0}
    assert isinstance(restored, TrainState)
    _equal_states(restored, state)
    # an async save owns its snapshot: a later change to the state does
    # not reach the file
    mgr.save(5, state, blocking=False)
    for leaf in tree_leaves(state.params):
        leaf.add_(1.0)
    restored, _ = mgr.restore(template, step=5)
    assert not torch.equal(restored.params["embed"], state.params["embed"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(template)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    state, _ = _state(cfg)
    assert state.params["embed"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    restored, _ = mgr.restore(state)
    _equal_states(restored, state)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor_compressed"])
def test_a_reference_checkpoint_restores_into_the_port(opt_name, tmp_path):
    """The reference trains two steps and saves; the port restores into
    its own TrainState with equal arrays, and writes a checkpoint the
    reference restores with equal arrays."""
    ref_cfg, cfg = ref_get_arch("smollm-135m").reduced(), _cfg()
    if opt_name == "adamw":
        ref_opt, opt, ref_comp, comp = RefAdamW(lr=1e-3), AdamW(lr=1e-3), None, None
    else:
        ref_opt, opt = RefAdafactor(lr=5e-3), Adafactor(lr=5e-3)
        ref_comp, comp = RefCompressor(True), ErrorFeedbackCompressor(True)
    params = RT.init_lm(jax.random.key(0), ref_cfg)
    init_fn, step_fn = ref_make_train_step(ref_lm_loss_fn(ref_cfg), ref_opt,
                                           ref_comp)
    state = init_fn(params)
    for i in range(2):
        state, _ = jax.jit(step_fn)(state, {"tokens": jnp.asarray(
            ref_pipeline.lm_batch(ref_cfg, 4, 16, 0, i)["tokens"])})
    RefCheckpointManager(str(tmp_path / "ref")).save(2, state,
                                                     extra={"seed": 0})

    template, _ = _state(cfg, opt, comp, seed=5)
    mine, man = CheckpointManager(str(tmp_path / "ref")).restore(template)
    assert man["step"] == 2
    want = convert.train_state_from_numpy(jax.tree.map(np.asarray, state),
                                          cfg, device=CPU)
    _equal_states(mine, want)
    np.testing.assert_array_equal(
        mine.params["layers"]["wq"]["w"].numpy(),
        np.asarray(state.params["layers"]["wq"]["w"]))

    CheckpointManager(str(tmp_path / "port")).save(2, mine)
    back, _ = RefCheckpointManager(str(tmp_path / "port")).restore(state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_state_carries_across_both_ways():
    cfg = _cfg()
    state, step_fn = _state(cfg, Adafactor(lr=5e-3), ErrorFeedbackCompressor(True))
    state, _ = _run(step_fn, state, cfg, 0, 2)
    arrays = convert.train_state_to_numpy(state)
    assert sorted(arrays) == ["comp_state", "opt_state", "params", "step"]
    assert arrays["step"].dtype == np.int32 and int(arrays["step"]) == 2
    back = convert.train_state_from_numpy(arrays, cfg, device=CPU)
    _equal_states(back, state)


def test_a_resumed_run_equals_an_unbroken_one_bit_for_bit(tmp_path):
    cfg = _cfg()
    state0, step_fn = _state(cfg)
    unbroken, losses_a = _run(step_fn, state0, cfg, 0, 4)
    half, losses_b = _run(step_fn, state0, cfg, 0, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, half, extra={"seed": 0}, blocking=False)
    fresh, _ = _state(cfg, seed=1)
    restored, man = mgr.restore(fresh)
    resumed, more = _run(step_fn, restored, cfg, man["step"], 4)
    assert losses_a == losses_b + more
    _equal_states(resumed, unbroken)


def test_the_launcher_runs_saves_and_resumes(tmp_path, capsys):
    args = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--log-every", "2",
            "--ckpt-every", "2"]
    launch_train.main(args + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "step     4  loss" in out and out.rstrip().endswith("done.")
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [2, 4]
    launch_train.main(args + ["--steps", "6", "--resume", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert "resumed from step 4" in capsys.readouterr().out
    launch_train.main(args + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "b")])
    capsys.readouterr()
    cfg = _cfg()
    template, _ = _state(cfg)
    a, _ = CheckpointManager(str(tmp_path / "a")).restore(template)
    b, _ = CheckpointManager(str(tmp_path / "b")).restore(template)
    _equal_states(a, b)
    launch_train.main(args + ["--steps", "2", "--compress-grads"])
    assert "done." in capsys.readouterr().out


def test_the_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "smollm-135m", "--reduced",
                           "--steps", "1"])
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "gcn-cora", "--device", "cpu"])
