"""Fault tolerance: heartbeats, elastic remesh plans, and what replica loss
does to privacy.

The paper's threat model fixes d_a corrupt servers *by assumption*; fleet
operations don't get that luxury. When a pod (= one PIR replica group)
drops out, the scheme keeps serving with d' = d − failed servers — but the
adversary doesn't shrink, so ε degrades exactly as the closed forms say
with d' substituted for d (cf. the multi-server trade-offs in
"Multi-Server Weakly-Private Information Retrieval"). Once d' ≤ d_a every
surviving server may be corrupt and privacy is gone (ε = ∞): the planner
must refuse to serve, not degrade silently. :func:`pir_degraded_privacy`
computes both facts from the same `core.accounting` formulas the configs
use, so ops and accounting can never disagree (asserted in
tests/test_torch_fault.py, which also holds every float against the JAX
package's).

:func:`plan_elastic_remesh` is the training-side analogue: survivors are
reassembled into a smaller mesh and the global batch rescales with pod
count. The port keeps the reference's pod-mesh plan as data: it serves on
one card, so a plan is recorded (``ServingPipeline.last_remesh``) and
nothing is remeshed on the device.

The live-serving wiring (DESIGN.md §Fleet harness): a
:class:`HeartbeatMonitor` turns raw heartbeats into alive→dead *edge*
events and fires registered pipeline hooks exactly once per death;
:func:`scheme_degradation` rebuilds a staged scheme for the survivor
count and returns it together with its :func:`pir_degraded_privacy`
accounting — the two are computed from the same closed forms and
cross-checked at the call site, so the scheme the pipeline swaps in can
never disagree with the ε it advertises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import accounting

__all__ = [
    "POD_MESH_SHAPE",
    "POD_MESH_AXES",
    "FleetState",
    "HeartbeatMonitor",
    "RemeshPlan",
    "plan_elastic_remesh",
    "pir_degraded_privacy",
    "scheme_degradation",
]

# One production pod of the reference deployment: 16×16 chips,
# ("data", "model").
POD_MESH_SHAPE = (16, 16)
POD_MESH_AXES = ("data", "model")


# --------------------------------------------------------------------------
# Heartbeats
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FleetState:
    """Last-heartbeat bookkeeping for n_pods replica groups.

    A pod that has never heartbeated is dead (conservative: a booting pod
    must prove liveness before the planner counts on it).
    """

    n_pods: int
    heartbeat_timeout_s: float = 30.0
    last_beat: Dict[int, float] = dataclasses.field(default_factory=dict)

    def heartbeat(self, pod: int, now: float) -> None:
        if not (0 <= pod < self.n_pods):
            raise ValueError(f"pod {pod} out of range [0, {self.n_pods})")
        self.last_beat[pod] = max(now, self.last_beat.get(pod, -math.inf))

    def _alive(self, pod: int, now: float) -> bool:
        # half-open window [last, last + timeout): a beat landing exactly
        # one timeout ago is already dead, deterministically — a closed
        # boundary would flap alive/dead across callers sampling `now`
        # microseconds apart (tests/test_torch_fault.py pins the boundary)
        last = self.last_beat.get(pod)
        return last is not None and now - last < self.heartbeat_timeout_s

    def alive_pods(self, now: float) -> List[int]:
        return [p for p in range(self.n_pods) if self._alive(p, now)]

    def dead_pods(self, now: float) -> List[int]:
        return [p for p in range(self.n_pods) if not self._alive(p, now)]


class HeartbeatMonitor:
    """Edge-detecting liveness monitor: :class:`FleetState` + pipeline hooks.

    :class:`FleetState` answers "who is alive *now*"; the serving side
    needs the *transition* — a replica that WAS alive and stopped beating.
    ``poll(now)`` fires every registered ``on_failure(newly_dead, alive)``
    callback exactly once per death edge (typically
    ``ServingPipeline.degrade_replicas``, which remeshes and re-prices ε).
    A pod that has never heartbeated is dead per FleetState's conservative
    rule but fires no failure edge — a booting fleet must prove liveness
    before its silence means loss. A revival (fresh heartbeat after a
    reported death) re-arms the edge, so a flapping replica reports each
    distinct death.
    """

    def __init__(self, n_pods: int, *, heartbeat_timeout_s: float = 30.0):
        self.state = FleetState(n_pods, heartbeat_timeout_s)
        self._seen_alive: Set[int] = set()
        self._reported_dead: Set[int] = set()
        self._callbacks: List[Callable[[List[int], List[int]], None]] = []

    def on_failure(
        self, callback: Callable[[List[int], List[int]], None]
    ) -> None:
        """Register ``callback(newly_dead, alive_now)``; fired from
        :meth:`poll` on each death edge, in registration order."""
        self._callbacks.append(callback)

    def heartbeat(self, pod: int, now: float) -> None:
        self.state.heartbeat(pod, now)
        self._seen_alive.add(pod)
        self._reported_dead.discard(pod)  # revival re-arms the death edge

    def poll(self, now: float) -> List[int]:
        """Detect death edges at ``now``; returns the newly-dead pods
        (after firing the callbacks — callbacks see a consistent world
        where the deaths have already been recorded)."""
        dead = [
            p for p in self.state.dead_pods(now) if p in self._seen_alive
        ]
        newly = [p for p in dead if p not in self._reported_dead]
        if newly:
            self._reported_dead.update(newly)
            alive = self.state.alive_pods(now)
            for cb in self._callbacks:
                cb(list(newly), list(alive))
        return newly


# --------------------------------------------------------------------------
# Elastic remesh
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    survivors: tuple
    mesh_shape: tuple
    mesh_axes: tuple
    global_batch_scale: float
    restore_from_checkpoint: bool = True


def plan_elastic_remesh(alive_pods: Sequence[int]) -> RemeshPlan:
    """Plan the post-failure topology from the surviving pod ids.

    One pod collapses to the plain ("data", "model") pod mesh; k > 1 pods
    keep a leading data-parallel "pod" axis of size k. The global batch
    scales linearly with pod count (the "pod" axis is pure DP), and the
    restart always goes through a checkpoint restore — checkpoints are
    topology-free, so restoring onto the new mesh is the normal path.
    """
    survivors = tuple(sorted(alive_pods))
    k = len(survivors)
    if k == 0:
        raise RuntimeError("no surviving pods: nothing to remesh onto")
    if k == 1:
        shape, axes = POD_MESH_SHAPE, POD_MESH_AXES
    else:
        shape = (k,) + POD_MESH_SHAPE
        axes = ("pod",) + POD_MESH_AXES
    return RemeshPlan(
        survivors=survivors,
        mesh_shape=shape,
        mesh_axes=axes,
        global_batch_scale=float(k),
        restore_from_checkpoint=True,
    )


# --------------------------------------------------------------------------
# Privacy under replica loss
# --------------------------------------------------------------------------
def pir_degraded_privacy(
    *,
    d: int,
    d_a: int,
    failed: int,
    scheme: str,
    n: int,
    theta: Optional[float] = None,
    p: Optional[int] = None,
    t: Optional[int] = None,
    u: int = 1,
) -> Dict[str, float]:
    """Privacy of a d-server deployment after ``failed`` servers drop.

    The d' = d − failed survivors keep answering; d_a (the adversary) is
    unchanged — failures are assumed to hit honest servers, the worst case.
    Returns ``{"d_effective", "serviceable", "epsilon", "delta"}``:
    serviceable == 0.0 (and ε = ∞) once d' ≤ d_a, because privacy would
    rest entirely on corrupt servers; the engine must stop admitting
    queries rather than serve at ε = ∞.
    """
    if not (0 <= failed <= d):
        raise ValueError(f"need 0 <= failed <= d, got failed={failed}, d={d}")
    d_eff = d - failed
    out: Dict[str, float] = {"d_effective": float(d_eff), "delta": 0.0}

    if d_eff <= d_a or d_eff < 1:
        out.update(serviceable=0.0, epsilon=math.inf)
        return out

    # "as-<base>" = the base scheme behind a u-user anonymity system: the
    # base ε degrades with d' exactly as below, then the Composition Lemma
    # applies unchanged (the AS does not shrink with the fleet). For
    # direct this reproduces Security Thm 2 exactly: e^{2ε_direct} is the
    # squared ratio inside epsilon_as_direct.
    scheme = scheme.lower()
    anon = scheme.startswith("as-")
    base = scheme[3:] if anon else scheme
    if base in ("chor", "it-pir"):
        # information-theoretic: perfect while ≥ 1 honest server survives
        eps = 0.0
    elif base == "sparse":
        if theta is None:
            raise ValueError("sparse schemes need theta")
        eps = accounting.epsilon_sparse(theta, d_eff, d_a)
    elif base == "direct":
        if p is None:
            raise ValueError("direct schemes need p")
        eps = accounting.epsilon_direct(n, d_eff, d_a, p)
    elif base == "subset":
        if t is None:
            raise ValueError("subset needs t")
        eps = 0.0
        out["delta"] = accounting.delta_subset(d_eff, d_a, min(t, d_eff))
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    if anon:
        eps = accounting.compose_with_anonymity(eps, u)

    out.update(serviceable=1.0, epsilon=eps)
    return out


def scheme_degradation(
    scheme: Any, n: int, failed: int
) -> Tuple[Optional[Any], Dict[str, float]]:
    """Rebuild a staged scheme for d' = d − failed survivors, with its
    degraded privacy accounted.

    The ops side of :func:`pir_degraded_privacy`: given the scheme a
    pipeline is serving (a staged SchemeProtocol instance, including
    ``Anonymized`` wrappers, or the back-compat facade), return
    ``(degraded_scheme, info)`` where ``info`` is the
    :func:`pir_degraded_privacy` dict and ``degraded_scheme`` is a fresh
    registry-built instance at d' — or None when unserviceable
    (d' ≤ d_a, or a survivor count the scheme cannot run on at all).

    Parameters constrained by the server count are re-fitted to d' and
    the accounting uses the *re-fitted* values: Subset-PIR's ``t`` clamps
    to the survivors (δ re-priced for the smaller pool), Direct's ``p``
    rounds down to a multiple of d' (dummy budget re-partitioned; fewer
    dummies ⇒ the ε the survivors actually provide). The returned
    scheme's own ``privacy(n)`` therefore equals ``info["epsilon"]`` /
    ``info["delta"]`` exactly — verified here, so the scheme a pipeline
    swaps in can never disagree with the ε it accounts
    (tests/test_torch_fault.py pins the equality per scheme).
    """
    from repro_torch.core.protocol import Anonymized, as_protocol, build_scheme

    proto = as_protocol(scheme)
    u = None
    if isinstance(proto, Anonymized):
        u = int(proto.u)
        proto = as_protocol(proto.base)
    d, d_a = int(proto.d), int(proto.d_a)
    if not (0 <= failed <= d):
        raise ValueError(f"need 0 <= failed <= d, got failed={failed}, d={d}")
    d_eff = d - failed
    name = proto.name
    params = {
        f.name: getattr(proto, f.name)
        for f in dataclasses.fields(proto)
        if f.name not in ("d", "d_a") and getattr(proto, f.name) is not None
    }

    dead = {
        "d_effective": float(d_eff), "delta": 0.0,
        "serviceable": 0.0, "epsilon": math.inf,
    }
    if d_eff <= d_a or d_eff < 1:
        return None, dead
    if name == "subset" and d_eff < 2:
        # subset needs ≥ 2 servers to contact; one survivor can't run it
        return None, dead

    if name == "subset" and "t" in params:
        params["t"] = max(2, min(int(params["t"]), d_eff))
    if name == "direct" and "p" in params:
        p0 = int(params["p"])
        params["p"] = max(d_eff, p0 - p0 % d_eff)

    full_name = f"as-{name}" if u is not None else name
    kw = dict(params)
    if u is not None:
        kw["u"] = u
    degraded = build_scheme(full_name, d_eff, d_a, **kw)
    info = pir_degraded_privacy(
        d=d, d_a=d_a, failed=failed, scheme=full_name, n=n,
        theta=params.get("theta"), p=params.get("p"), t=params.get("t"),
        u=u if u is not None else 1,
    )
    eps, delta = degraded.privacy(n)
    if not (
        math.isclose(eps, info["epsilon"], rel_tol=1e-9, abs_tol=1e-12)
        and math.isclose(delta, info["delta"], rel_tol=1e-9, abs_tol=1e-12)
    ):
        raise RuntimeError(
            f"degraded scheme privacy {(eps, delta)} disagrees with "
            f"pir_degraded_privacy {info!r} for {full_name} at d'={d_eff}"
        )
    return degraded, info
