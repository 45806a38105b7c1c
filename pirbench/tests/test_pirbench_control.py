"""What ``correct`` rests on fails when it should: the control each
configuration names, and the timed path broken underneath a run (the
harness's look for a card skipped: the run is on the CPU, at a size it
holds)."""

import pytest
import torch

from _tiny import run_tiny, tiny_cell

CELLS = ["ct_sparse.online", "ct_chor.audit", "ct_sparse.audit",
         "ct_chor.online"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    control = {k: v for k, v in tiny_cell(workload).config["control"].items()
               if k != "why"}
    res = run_tiny(workload, overrides=control)
    assert not res["correct"]
    failed = {k for k, c in res["limits"].items()
              if not c["value"] <= c["limit"] and c["rule"] == "<="}
    assert failed & {"density_z", "eps_gap"}, res["limits"]


def _flip_first_answer(responses):
    out = responses.clone()
    out[0, 0, 0] ^= 1
    return out


def _drop_half(responses):
    out = responses.clone()
    out[:, out.shape[1] // 2:] = 0
    return out


def _unchanged(responses):
    return torch.zeros_like(responses)


@pytest.mark.parametrize("fault", [_flip_first_answer, _drop_half,
                                   _unchanged])
@pytest.mark.parametrize("workload", ["ct_sparse.audit", "ct_chor.online"])
def test_a_broken_answer_stage_is_not_correct(monkeypatch, workload, fault):
    from repro_torch.serve.sharded import ShardedBackend

    answer = ShardedBackend.answer_batch

    def broken(self, routed, **kw):
        return fault(answer(self, routed, **kw))

    monkeypatch.setattr(ShardedBackend, "answer_batch", broken)
    res = run_tiny(workload)
    assert not res["correct"]
    assert res["limits"]["lookup_errors"]["value"] > 0 or \
        res["limits"]["answer_errors"]["value"] > 0


def test_a_wrong_record_at_reconstruction_is_not_correct(monkeypatch):
    from repro_torch.serve.router import SchemeRouter

    finalize = SchemeRouter.finalize

    def broken(self, routed, responses):
        out = finalize(self, routed, responses)
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(SchemeRouter, "finalize", broken)
    res = run_tiny("ct_sparse.online")
    assert not res["correct"]
    assert res["limits"]["lookup_errors"]["value"] > 0
    assert res["limits"]["answer_errors"]["value"] == 0
