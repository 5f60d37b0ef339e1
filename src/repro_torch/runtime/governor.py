"""Adaptive mode-split governor (the paper's run-time decision, online),
after ``repro.runtime.governor``.

The paper's Morpheus software stack decides per kernel launch how many
cores enter cache mode; the offline analogue in this repo is
``policy.best_split`` (a full sweep per app).  The governor makes that
decision *online*: it observes per-epoch telemetry from the epoch-
streaming engine (``runtime.stream``) or the serving page pool and walks
the same candidate list the offline policy sweeps
(``policy.grid_points``), using

  * **hill-climbing** — it only ever moves to a neighbouring split in the
    candidate list (mode transitions are expensive: departing slices are
    flushed);
  * **epsilon-greedy exploration** — with decaying probability it visits
    a neighbour it knows least about, so a stationary workload converges
    while estimates keep refreshing;
  * **hysteresis** — a minimum dwell (epochs) at a split before moving
    again, plus a minimum relative gain to accept a move;
  * **phase-shift detection** — if the observed reward of the *current*
    split suddenly deviates from its estimate (CABA-style phase
    behaviour), all estimates are stale: they are cleared and the
    exploration rate resets.

``simulate_online`` drives the whole loop against the trace simulator:
epoch replay via ``EngineState`` carries, warm-state handoff on split
changes, per-epoch ``EpochRecord`` telemetry, and an aggregate modeled
IPC comparable with the offline policy's.

The governors (``Governor``, ``GovernorConfig``, ``ServingGovernor``) are
host logic, copied from the reference.  ``OnlineReplica`` and
``simulate_online`` run over the port's ``engine.pack`` and
``engine.advance_packed`` on ``device`` (None: the CUDA card, whose
stateful scans then run once an epoch; ``"cpu"``: the plain versions);
``demo_pool`` builds the port's ``MorpheusPagePool`` on ``device``.
Epoch Stats come back to the host as numpy leaves, and every reward is
formed from them with the reference's numpy arithmetic.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, fields, replace
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import obs
from ..core import cache_sim as cs
from ..core import engine
from ..core import policy
from ..core import traces as tr
from ..obs.decision import DecisionEvent
from ..core.compression import BLOCK_BYTES
from ..core.controller import Stats
from ..core.engine import EngineState
from . import stream as rt_stream
from .telemetry import EpochRecord, TelemetryLog, jains_index

Split = Tuple[int, int]      # (n_compute, n_cache)


@dataclass(frozen=True)
class GovernorConfig:
    hysteresis: int = 2          # min epochs at a split before moving again
    min_gain: float = 0.03       # relative reward gain required to move
    epsilon: float = 0.25        # initial exploration probability
    epsilon_decay: float = 0.95  # per-decision decay
    epsilon_min: float = 0.08
    # When the bottleneck hint points at a neighbour whose estimate is
    # stale (not visited for hint_stale_after epochs) or unknown, explore
    # it with probability epsilon_hint instead: headroom is likely and the
    # cost of checking is one short visit.  Once measured, greedy logic
    # decides.  A hinted visit that measures NO better than where it came
    # from is a *strike* against that direction; after hint_max_strikes
    # the boost is suppressed until a phase reset — the hint is a
    # heuristic and the measurements outrank it.
    epsilon_hint: float = 0.9
    hint_stale_after: int = 12
    hint_max_strikes: int = 2
    # Reward estimates update asymmetrically: a higher reward is adopted
    # immediately (cache warm-up approaches steady state from below, so
    # the recent maximum is the best steady-state predictor), a lower one
    # only blends in slowly (transient dips should not demote a split —
    # genuine regime changes are caught by the phase detector instead).
    ema_up: float = 1.0
    ema_down: float = 0.25
    warm_epochs: int = 2         # post-switch epochs excluded from estimates
    phase_threshold: float = 0.3   # relative surprise that flags a phase shift
    # A phase can be invisible in the reward (fully-cached epochs all
    # saturate at the compute ceiling) but not in the telemetry: a jump in
    # the observable signature (hit rate) at the SAME split flags a phase
    # shift even when the reward doesn't move.
    signature_threshold: float = 0.15
    # Per-phase memory (CABA-style): phases are fingerprinted by their
    # observable signature quantized into ``phase_bins`` buckets; when a
    # shift lands in a bucket seen before, the governor jumps straight to
    # the split it had converged to there instead of re-climbing the
    # ladder.  The jump is still a normal transition (flush + warm-up),
    # and a wrong table entry self-corrects: estimates restart fresh, so
    # greedy moves walk away if the remembered split no longer wins.
    phase_memory: bool = True
    phase_bins: int = 6
    # QoS objective over per-tenant rewards (multi-tenant replay only;
    # docs/qos.md).  "global": the classic mixed-epoch IPC.  "weighted":
    # weighted mean of per-tenant IPCs — skewing a weight steers the
    # governor toward that tenant's preferred split.  "minf": weighted
    # max-min fairness, max over splits of min_k(ipc_k / w_k) — the
    # governor serves the worst-off tenant first.  ``tenant_weights``
    # (None = uniform) must match the workload's tenant count.
    objective: str = "global"
    tenant_weights: Optional[Tuple[float, ...]] = None
    seed: int = 0

    def __post_init__(self):
        assert self.objective in ("global", "weighted", "minf"), \
            f"unknown objective {self.objective!r}"


# Conservative preset for bursty multi-tenant replay (fig_serving, the
# serving launchers): under a bursty arrival process the per-epoch mix
# composition swings constantly, so the default config's eager phase
# resets + hint probing thrash between splits on a *stationary* tenant
# mix.  This preset damps both — wider surprise thresholds, rarer and
# once-refuted-then-dropped hint probes — trading reaction speed for
# stability; measured on cfd+kmeans under MMPP it converges to the
# offline-best split with a bounded (<10%) adaptation tax.
SERVING_GCFG = GovernorConfig(
    hysteresis=3, min_gain=0.08, epsilon=0.15, epsilon_min=0.03,
    phase_threshold=0.5, signature_threshold=0.35,
    hint_stale_after=40, hint_max_strikes=1)


_GCFG_FIELDS = {f.name: f.type for f in fields(GovernorConfig)}
_GCFG_INT = ("hysteresis", "hint_stale_after", "hint_max_strikes",
             "warm_epochs", "phase_bins", "seed")
_GCFG_FLOAT = ("min_gain", "epsilon", "epsilon_decay", "epsilon_min",
               "epsilon_hint", "ema_up", "ema_down", "phase_threshold",
               "signature_threshold")


def gcfg_from_dict(d: Mapping, base: GovernorConfig = SERVING_GCFG
                   ) -> GovernorConfig:
    """Build a ``GovernorConfig`` from plain (JSON-decodable) values.

    The autotuner's decode hook: a search space samples flat dicts of
    hyperparameters, this turns one into a config by overlaying it on
    ``base`` (default: the serving preset, so a search varies only the
    knobs it declares).  Unknown keys fail loudly — a typo in a knob
    name must not silently tune nothing.  Numeric fields are coerced so
    JSON round-trips (which turn ints into floats and vice versa) cannot
    change governor behaviour.
    """
    kw = {}
    for k, v in d.items():
        if k not in _GCFG_FIELDS:
            raise ValueError(f"unknown GovernorConfig field {k!r} "
                             f"(known: {sorted(_GCFG_FIELDS)})")
        if k in _GCFG_INT:
            v = int(v)
        elif k in _GCFG_FLOAT:
            v = float(v)
        elif k == "phase_memory":
            v = bool(v)
        elif k == "tenant_weights" and v is not None:
            v = tuple(float(x) for x in v)
        kw[k] = v
    return replace(base, **kw)


class GovernorState(NamedTuple):
    """Host-side snapshot of a ``Governor``'s mutable state.

    An explicit pytree (scalar/dict leaves) instead of live object
    attributes, so a replica's governor can be exported, checkpointed,
    shared across a fleet (the ``runtime.fleet.SplitAdvisor`` warm
    start reads the tables out of one replica's state and seeds
    another's) and restored bit-exactly — including the numpy RNG
    state, so a restored governor's decision stream continues exactly
    where the exported one stopped.  The candidate list itself is
    configuration, not state: ``restore_state`` requires the same
    candidates the state was exported under.
    """
    index: int                       # current candidate index
    est: Dict[int, float]            # candidate -> reward estimate
    sig: Dict[int, float]            # candidate -> last signature
    last_visit: Dict[int, int]       # candidate -> last epoch visited
    eps: float
    dwell: int
    warm_left: int
    measured: bool
    hint: int
    hint_strikes: Dict[int, int]
    probe: Optional[Tuple[int, Optional[float]]]
    phase_table: Dict[int, int]
    phase_key: Optional[int]
    jumped: bool
    ctx: Optional[int]
    ctx_table: Dict[int, int]
    pending_jump: Optional[int]
    churn_resets: int
    epoch: int
    switches: int
    phase_shifts: int
    phase_jumps: int
    last_switched: bool
    rng_state: Dict                  # numpy bit-generator state
    pressure: float = 0.0            # last observed overload pressure


class Governor:
    """Epsilon-greedy hill-climber over an ordered candidate list.

    Candidates can be anything hashable and *ordered by aggressiveness*
    (here: mode splits sorted by compute-core count); neighbourhood is
    adjacency in the list.  Drive it with ``observe(reward)`` after each
    epoch run at ``current``, then ``decide()`` for the next epoch's
    candidate.
    """

    def __init__(self, candidates: Sequence, cfg: GovernorConfig
                 = GovernorConfig(), *, initial: Optional[int] = None):
        assert candidates, "governor needs at least one candidate"
        self.candidates = list(candidates)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._i = len(self.candidates) // 2 if initial is None else initial
        self.est: Dict[int, float] = {}
        self.sig: Dict[int, float] = {}          # candidate -> last signature
        self.last_visit: Dict[int, int] = {}
        self.eps = cfg.epsilon
        self.dwell = 0
        # the initial epochs fill a cold cache exactly like a post-switch
        # transient: exclude them from the first split's estimate too
        self.warm_left = cfg.warm_epochs
        self.measured = False    # has this visit recorded a real epoch yet?
        self.hint = 0
        self.pressure = 0.0      # overload pressure (admission coupling)
        self.hint_strikes: Dict[int, int] = {}   # direction -> refutations
        self._probe: Optional[Tuple[int, float]] = None  # (dir, origin est)
        self.phase_table: Dict[int, int] = {}    # phase key -> best index
        self._phase_key: Optional[int] = None    # current phase's key
        self._jumped = False
        # external phase context (the active-tenant signature of a churn
        # workload): a context change is a churn event — estimates reset
        # like a phase shift, and phase-table keys embed the context so a
        # mix's memory never collides with another mix's.  None until the
        # first set_context: the initial mix is not a churn event.
        self._ctx: Optional[int] = None
        self.ctx_table: Dict[int, int] = {}      # context -> best index
        self._pending_jump: Optional[int] = None
        self.churn_resets = 0
        self.epoch = 0
        self.switches = 0
        self.phase_shifts = 0
        self.phase_jumps = 0                     # re-entries served by memory
        self.last_switched = False
        # decision provenance: one DecisionEvent per fired decision path
        # (docs/observability.md).  Recording is pure bookkeeping — no
        # RNG draw, no estimate change — so the decision stream is
        # bit-identical with observability on or off.
        self.decisions: List[DecisionEvent] = []

    def _sig_bucket(self, signature: float) -> int:
        b = self.cfg.phase_bins
        return min(b - 1, max(0, int(float(signature) * b)))

    def _phase_key_of(self, signature: float) -> int:
        """Phase-table key: signature bucket qualified by the external
        context, so e.g. 'hit rate 0.7 with tenants {A,B}' and 'hit rate
        0.7 with tenant {B}' are distinct phases."""
        ctx = self._ctx if self._ctx is not None else 0
        return ctx * self.cfg.phase_bins + self._sig_bucket(signature)

    def _record(self, trigger: str, to: int) -> DecisionEvent:
        """Append one provenance event (call BEFORE mutating ``_i``)."""
        ev = DecisionEvent(
            epoch=self.epoch, trigger=trigger,
            from_split=self.candidates[self._i],
            to_split=self.candidates[to],
            epsilon=self.eps, hint=self.hint,
            estimates={str(self.candidates[j]): float(v)
                       for j, v in sorted(self.est.items())},
            ctx=self._ctx)
        self.decisions.append(ev)
        return ev

    def _jump_to(self, j: int, trigger: str = "phase_jump") -> None:
        """Adopt a remembered split: an ordinary transition (flush +
        warm-up) whose estimates restart fresh."""
        self._record(trigger, j)
        self._i = j
        self.dwell = 0
        self.warm_left = self.cfg.warm_epochs
        self.measured = False
        self._probe = None
        self.switches += 1
        self.phase_jumps += 1
        self._jumped = True

    # ------------------------------------------------------------ context
    def set_context(self, tag: int) -> None:
        """Declare the external phase context (e.g. the active-tenant
        bitmask).  A change is a *churn event*: every estimate describes
        a tenant mix that no longer exists, so they are cleared like a
        phase shift; the departing context's converged split is
        remembered, and re-entering a known context jumps straight to
        its remembered split (same self-correction story as the
        signature phase table)."""
        tag = int(tag)
        if tag == self._ctx:
            return
        if self._ctx is None:        # first mix of the run, not a churn
            self._ctx = tag
            return
        if self.cfg.phase_memory and self.est:
            best = max(self.est, key=lambda j: self.est[j])
            self.ctx_table[self._ctx] = best
            if self._phase_key is not None:
                self.phase_table[self._phase_key] = best
        # provenance: the reset itself changes no split (a remembered
        # mix's jump is deferred and recorded as ctx_reentry in decide())
        self._record("churn_reset", self._i)
        self._ctx = tag
        self.est = {}
        self.sig = {}
        self.hint_strikes = {}
        self.eps = self.cfg.epsilon
        self._phase_key = None
        self.churn_resets += 1
        # the jump is deferred to the next decide(): the caller is about
        # to observe() the first epoch of the new mix, which ran at the
        # *current* split — its reward must be recorded there, not at the
        # remembered split
        known = self.ctx_table.get(tag) if self.cfg.phase_memory else None
        if known is not None and known != self._i:
            self._pending_jump = known

    @property
    def current(self):
        return self.candidates[self._i]

    def best_estimate(self) -> Optional[Tuple[object, float]]:
        """(candidate, estimated reward) of the best-known candidate, or
        None before any measured epoch — what the fleet's split-advisor
        shares across replicas serving the same mix."""
        if not self.est:
            return None
        j = max(self.est, key=lambda k: self.est[k])
        return self.candidates[j], self.est[j]

    # -------------------------------------------------------- state pytree
    def export_state(self) -> GovernorState:
        """Snapshot every mutable field (dicts copied, RNG included)."""
        return GovernorState(
            index=self._i, est=dict(self.est), sig=dict(self.sig),
            last_visit=dict(self.last_visit), eps=self.eps,
            dwell=self.dwell, warm_left=self.warm_left,
            measured=self.measured, hint=self.hint,
            hint_strikes=dict(self.hint_strikes), probe=self._probe,
            phase_table=dict(self.phase_table), phase_key=self._phase_key,
            jumped=self._jumped, ctx=self._ctx,
            ctx_table=dict(self.ctx_table),
            pending_jump=self._pending_jump,
            churn_resets=self.churn_resets, epoch=self.epoch,
            switches=self.switches, phase_shifts=self.phase_shifts,
            phase_jumps=self.phase_jumps,
            last_switched=self.last_switched,
            rng_state=self.rng.bit_generator.state,
            pressure=self.pressure)

    def restore_state(self, s: GovernorState) -> None:
        """Inverse of ``export_state``.  The governor must have been
        built over the same candidate list the state was exported
        under (indices in the state refer into it)."""
        assert 0 <= s.index < len(self.candidates), \
            "state does not match this governor's candidate list"
        self._i = s.index
        self.est = dict(s.est)
        self.sig = dict(s.sig)
        self.last_visit = dict(s.last_visit)
        self.eps = s.eps
        self.dwell = s.dwell
        self.warm_left = s.warm_left
        self.measured = s.measured
        self.hint = s.hint
        self.hint_strikes = dict(s.hint_strikes)
        self._probe = s.probe
        self.phase_table = dict(s.phase_table)
        self._phase_key = s.phase_key
        self._jumped = s.jumped
        self._ctx = s.ctx
        self.ctx_table = dict(s.ctx_table)
        self._pending_jump = s.pending_jump
        self.churn_resets = s.churn_resets
        self.epoch = s.epoch
        self.switches = s.switches
        self.phase_shifts = s.phase_shifts
        self.phase_jumps = s.phase_jumps
        self.last_switched = s.last_switched
        self.rng.bit_generator.state = s.rng_state
        self.pressure = getattr(s, "pressure", 0.0)

    # ------------------------------------------------------------ observe
    def observe(self, reward: float, hint: int = 0,
                signature: Optional[float] = None,
                pressure: float = 0.0) -> None:
        """Record the reward of one epoch run at ``current``.

        ``hint`` is the observed bottleneck direction (+1: the epoch was
        compute-bound, more compute cores can help; -1: it was memory/
        capacity-bound, more cache can help; 0: unknown).  It biases only
        *exploration* — moves still require measured reward gains — and is
        what lets the governor escape fully-cached plateaus where the
        reward saturates at the compute ceiling for every workload.

        ``signature`` is an observable phase fingerprint in [0, 1]
        (drivers pass the epoch hit rate): a jump vs. the last signature
        seen *at the same split* flags a phase shift even when the reward
        itself is saturated and doesn't move.

        ``pressure`` is the admission layer's overload signal — offered
        demand over round capacity (docs/qos.md).  Pressure > 1 means
        requests are being deferred or shed *right now*, so the hint's
        staleness gate is waived in ``decide()``: a hinted probe that
        would normally wait out ``hint_stale_after`` epochs fires
        immediately, and split adaptation stops fighting admission for
        whole deferral cycles.  The default 0.0 leaves the decision path
        byte-identical to the pre-admission governor."""
        self.epoch += 1
        self.last_visit[self._i] = self.epoch
        self.hint = int(np.sign(hint))
        self.pressure = float(pressure)
        if self.warm_left > 0:       # post-transition epoch: state re-warming
            self.warm_left -= 1
            return
        self.measured = True
        if self._probe is not None:  # first measurement of a hinted visit
            d, origin = self._probe
            self._probe = None
            if origin is not None and \
                    reward - origin <= self.cfg.min_gain * abs(origin):
                self.hint_strikes[d] = self.hint_strikes.get(d, 0) + 1
            else:
                self.hint_strikes[d] = 0
        prev = self.est.get(self._i)
        shifted = False
        if prev is not None and abs(prev) > 1e-12:
            surprise = abs(reward - prev) / abs(prev)
            shifted = surprise > self.cfg.phase_threshold
        if signature is not None and not shifted:
            prev_sig = self.sig.get(self._i)
            shifted = prev_sig is not None and \
                abs(signature - prev_sig) > self.cfg.signature_threshold
        if shifted:
            # the workload moved under us: every estimate is stale.  Before
            # discarding them, remember where the *departing* phase had
            # converged — if its signature bucket comes back, decide() can
            # jump straight there instead of re-climbing (CABA-style).
            if self.cfg.phase_memory and self._phase_key is not None \
                    and self.est:
                self.phase_table[self._phase_key] = \
                    max(self.est, key=lambda j: self.est[j])
            # provenance: capture the estimates being discarded; a
            # remembered bucket's jump is recorded separately below
            self._record("phase_shift", self._i)
            self.est = {}
            self.sig = {}
            self.hint_strikes = {}
            self.eps = self.cfg.epsilon
            self.phase_shifts += 1
            prev = None
        if signature is not None:
            self.sig[self._i] = signature
        if prev is None:
            self.est[self._i] = reward
        else:
            a = self.cfg.ema_up if reward >= prev else self.cfg.ema_down
            self.est[self._i] = (1.0 - a) * prev + a * reward
        if shifted and self.cfg.phase_memory and signature is not None:
            known = self.phase_table.get(self._phase_key_of(signature))
            if known is not None and known != self._i:
                # revisit of a remembered phase: jump to its best split
                self._jump_to(known)
        if signature is not None:
            self._phase_key = self._phase_key_of(signature)

    # ------------------------------------------------------------- decide
    def _neighbors(self) -> List[int]:
        return [j for j in (self._i - 1, self._i + 1)
                if 0 <= j < len(self.candidates)]

    def decide(self):
        """Choose the split for the next epoch (may equal ``current``)."""
        with obs.span("governor.decide", epoch=self.epoch):
            return self._decide()

    def _decide(self):
        if self._pending_jump is not None:   # churn re-entry (set_context)
            j, self._pending_jump = self._pending_jump, None
            if j != self._i:
                self._jump_to(j, "ctx_reentry")
        self.last_switched = self._jumped   # phase-memory/churn jump
        self._jumped = False
        self.dwell += 1
        # never move before this visit has recorded at least one measured
        # (post-warm-up) epoch — otherwise a visit teaches nothing
        if len(self.candidates) == 1 or not self.measured \
                or self.dwell < self.cfg.hysteresis \
                or self._i not in self.est:
            return self.current
        nbrs = self._neighbors()
        target = None
        probe = None
        trigger = ""
        hinted = self._i + self.hint
        hint_ok = bool(self.hint) and hinted in nbrs and \
            self.hint_strikes.get(self.hint, 0) < self.cfg.hint_max_strikes \
            and (hinted not in self.est    # nothing known (e.g. post-reset)
                 or self.epoch - self.last_visit.get(hinted, -10**9)
                 > self.cfg.hint_stale_after
                 or self.pressure > 1.0)   # overload: probe NOW, not later
        eps = max(self.eps, self.cfg.epsilon_hint) if hint_ok else self.eps
        if self.rng.random() < eps:
            # With a bottleneck hint, only ever explore in the hinted
            # direction (an against-the-hint dip at a converged optimum is
            # pure loss; at the ladder's edge, skip exploring entirely).
            # Without a hint, refresh the longest-unvisited neighbour.
            if self.hint:
                # a struck-out direction is not probed at all — the
                # measurements have repeatedly refuted the hint
                if hinted in nbrs and self.hint_strikes.get(
                        self.hint, 0) < self.cfg.hint_max_strikes:
                    target = hinted
                    probe = (self.hint, self.est.get(self._i))
                    trigger = "hint"
            else:
                target = min(nbrs,
                             key=lambda j: (self.last_visit.get(j, -1),
                                            self.rng.random()))
                trigger = "explore"
        else:
            known = [j for j in nbrs if j in self.est]
            if known:
                best = max(known, key=lambda j: self.est[j])
                cur = self.est[self._i]
                # sign-safe relative margin (rewards may be negative,
                # e.g. -latency in the serving governor)
                if self.est[best] - cur > self.cfg.min_gain * abs(cur):
                    target = best
                    trigger = "greedy"
        self.eps = max(self.cfg.epsilon_min, self.eps * self.cfg.epsilon_decay)
        if target is not None and target != self._i:
            self._record(trigger, target)
            self._i = target
            self.dwell = 0
            self.warm_left = self.cfg.warm_epochs
            self.measured = False
            self._probe = probe
            self.switches += 1
            self.last_switched = True
        return self.current


# -------------------------------------------------------- serving driver

class ServingGovernor:
    """Drives a serving page pool's cache-chip count from its observed
    request mix (the paper's mode-split decision at the serving tier).

    One *epoch* is whatever interval the caller chooses (a batch, a time
    slice); per tick it reads the pool's ``PoolStats`` delta, optimises

        reward = -(modeled ns per lookup  +  chip_cost_ns * chips)

    (the second term is the opportunity cost of holding chips in cache
    mode instead of compute), and applies the decision via
    ``pool.reconfigure`` — a mode transition that flushes the resident
    pages, exactly like the simulator's split change flushes slices.
    """

    def __init__(self, pool, chip_candidates: Sequence[int]
                 = (0, 1, 2, 4, 6, 8), *, chip_cost_ns: float = 15.0,
                 ema_alpha: float = 0.4,
                 gcfg: GovernorConfig = GovernorConfig()):
        cands = sorted(set(int(c) for c in chip_candidates)
                       | {pool.cfg.num_cache_chips})
        self.pool = pool
        self.chip_cost_ns = float(chip_cost_ns)
        self.gov = Governor(cands, gcfg,
                            initial=cands.index(pool.cfg.num_cache_chips))
        self._last = pool.stats
        # EMA over the per-tick reward: single serving ticks are noisy
        # (a handful of lookups), so the governor observes the smoothed
        # value.  Idle windows FREEZE it — blending an idle tick in
        # would decay the EMA toward the pure chip-cost term, and the
        # first busy tick after a long gap would then read as a phase
        # shift and wipe real estimates (tests/test_qos.py pins this).
        self.ema_alpha = float(ema_alpha)
        self.reward_ema: Optional[float] = None
        self.epoch = 0
        self.history: List[Dict] = []
        self._dec_seen = 0      # provenance events already attributed

    def tick(self, pressure: float = 0.0) -> Dict:
        """Consume the interval since the last tick; maybe reconfigure.
        Returns a record of the observation and the decision.

        ``pressure`` forwards the admission controller's overload signal
        (offered/capacity) into ``Governor.observe`` — under sustained
        overload (> 1) the chip governor probes its bottleneck hint
        immediately instead of waiting out the staleness gate.  The
        default 0.0 keeps the pre-admission path byte-identical."""
        chips = self.pool.cfg.num_cache_chips
        delta = self.pool.stats - self._last
        self._last = self.pool.stats
        tel = self.pool.telemetry()
        if delta.lookups == 0:
            # idle window: no requests means no observation — observe/
            # decide are skipped (a zero signature/reward sample would
            # fire the phase detector on every idle/busy boundary and
            # wipe real estimates; the simulator path merges near-empty
            # epochs for the same reason, arrivals.epochs_by_time) AND
            # the reward EMA is frozen: long idle gaps must not decay it
            # into a spurious phase-change signal on resume
            rec = {"epoch": self.epoch, "chips": chips, "lookups": 0,
                   "idle": True, "ns_per_lookup": 0.0,
                   "hit_rate_interval": 0.0,
                   "ext_occupancy": tel["ext_occupancy"],
                   "pred_accuracy": tel["pred_accuracy"], "reward": 0.0,
                   "reward_ema": self.reward_ema,
                   "hint": 0, "new_chips": chips, "switched": False,
                   "flushed_pages": 0, "epsilon": self.gov.eps}
            self.history.append(rec)
            self.epoch += 1
            return rec
        lookups = delta.lookups
        ns_per = delta.time_ns / lookups
        reward = -(ns_per + self.chip_cost_ns * chips)
        self.reward_ema = reward if self.reward_ema is None else \
            (1.0 - self.ema_alpha) * self.reward_ema \
            + self.ema_alpha * reward
        # bottleneck hint, in chip direction (+1 = provision more chips):
        # a saturated extended tier (or no tier at all) with misses means
        # capacity starvation; an underused tier wastes compute chips.
        ext_occ = tel["ext_occupancy"]
        hit = delta.conv_hits + delta.ext_hits
        if (chips == 0 or ext_occ > 0.85) and hit < 0.95 * delta.lookups:
            hint = +1
        elif chips > 0 and ext_occ < 0.30:
            hint = -1
        else:
            hint = 0
        self.gov.observe(self.reward_ema, hint, signature=hit / lookups,
                         pressure=pressure)
        ema_observed = self.reward_ema
        new_chips = self.gov.decide()
        flushed = 0
        if new_chips != chips:
            flushed = self.pool.reconfigure(new_chips)
            # the EMA mixes the old chip count's reward (different
            # chip-cost term, different latencies): reseed it at the new
            # split so post-switch estimates aren't cross-contaminated
            self.reward_ema = None
        for ev in self.gov.decisions[self._dec_seen:]:
            ev.replica = "serving"
            if flushed and ev.switched:
                ev.flush_writebacks = flushed
            ev.summary = {"hit_rate": hit / lookups, "ext_occupancy": ext_occ,
                          "pred_accuracy": tel["pred_accuracy"],
                          "reward": reward}
            obs.instant("governor.decision", **ev.to_dict())
        self._dec_seen = len(self.gov.decisions)
        ins = obs.inspector()
        if ins is not None and ins.wants(self.epoch):
            ins.record(self.pool.content_snapshot(epoch=self.epoch,
                                                  replica="serving",
                                                  owners=ins.owners))
            obs.count("state_snapshots", 1, path="serving")
        rec = {"epoch": self.epoch, "chips": chips, "lookups": int(
            delta.lookups), "ns_per_lookup": ns_per,
            "hit_rate_interval": hit / lookups, "ext_occupancy": ext_occ,
            "pred_accuracy": tel["pred_accuracy"], "reward": reward,
            "reward_ema": ema_observed,
            "hint": hint, "new_chips": new_chips,
            "switched": new_chips != chips, "flushed_pages": flushed,
            "epsilon": self.gov.eps}
        self.history.append(rec)
        self.epoch += 1
        return rec


DEMO_POOL_KW = dict(conv_sets=64, ext_sets_per_chip=32, ways=4)


def demo_pool(num_cache_chips: int, device=None):
    """The reduced page pool the reference's serving demos pin a split on
    (``launch/serve.py``, ``examples/serve_morpheus.py``), on ``device``
    (None: the CUDA card)."""
    from ..serving.paged_kv import MorpheusPagePool, PoolConfig
    return MorpheusPagePool(PoolConfig(num_cache_chips=num_cache_chips,
                                       **DEMO_POOL_KW), device)


def describe_tick(rec: Dict) -> str:
    """One-line human rendering of a ``ServingGovernor.tick`` record."""
    if rec.get("idle"):
        return (f"governor epoch {rec['epoch']}: chips {rec['chips']} "
                f"held (idle window, no lookups)")
    s = (f"governor epoch {rec['epoch']}: chips {rec['chips']} -> "
         f"{rec['new_chips']} | {rec['ns_per_lookup']:.0f} ns/lookup | "
         f"hit {rec['hit_rate_interval']:.2f} | hint {rec['hint']:+d}")
    if rec["switched"]:
        s += f" | flushed {rec['flushed_pages']} pages"
    return s


# ------------------------------------------------------------ sim driver

def candidates_for(app: str, system: str, *,
                   grid: Sequence[int] = policy.DEFAULT_GRID,
                   length: int = 60_000) -> List[Split]:
    """The governor's candidate splits = the offline policy's sweep grid
    for (app, system), plus the all-compute point (so compute-bound
    phases have somewhere to go), ordered by compute-core count."""
    pts = policy.grid_points(app, system, grid=grid, length=length)
    splits = [(p.n_compute, p.n_cache) for p in pts]
    if cs.SYSTEMS[system].morpheus and (cs.TOTAL_CORES, 0) not in splits:
        splits.append((cs.TOTAL_CORES, 0))
    return sorted(set(splits))


@dataclass
class OnlineResult:
    """Outcome of one online (governed or fixed-split) run."""
    system: str
    phases: List[str]
    records: List[EpochRecord]
    log: TelemetryLog
    stats: Stats                  # totals over all epochs (numpy leaves)
    ipc: float                    # time-weighted, all epochs
    steady_ipc: float             # time-weighted, post burn-in epochs
    converged_ipc: float          # post burn-in epochs at converged_split
    exec_time_s: float
    switches: int
    final_split: Split            # governor's choice when the run ended
    converged_split: Split        # most-dwelt split post burn-in
    churn_resets: int = 0         # tenant-churn context resets (QoS runs)
    # multi-tenant replay only: exact per-tenant Stats (numpy leaves; the
    # integer counters sum to ``stats`` up to the flush charges, which are
    # attributed to the tenant owning each flushed block)
    tenant_stats: Optional[Dict[str, Stats]] = None
    # governor decision provenance, in decision order: one DecisionEvent
    # per fired decision path, flush-cost-attributed (docs/observability.md)
    decisions: List[DecisionEvent] = None  # type: ignore[assignment]

    def tenant_hit_rates(self) -> Dict[str, float]:
        """Per-tenant LLC hit rates (multi-tenant replay only)."""
        if not self.tenant_stats:
            return {}
        from ..workloads.tenancy import hit_rate
        return {name: hit_rate(s) for name, s in self.tenant_stats.items()}

    def summary(self) -> Dict:
        out = {"system": self.system, "phases": self.phases,
               "epochs": len(self.records), "ipc": self.ipc,
               "steady_ipc": self.steady_ipc,
               "converged_ipc": self.converged_ipc,
               "switches": self.switches,
               "converged_split": self.converged_split,
               "final_split": self.final_split}
        if self.tenant_stats:
            out["tenant_hit_rates"] = self.tenant_hit_rates()
        return out


def tenant_epoch_ipcs(wl, system: str, nc: int, nk: int, lo: int, hi: int,
                      delta_rows: Stats, seed: int = 0,
                      counts: Optional[np.ndarray] = None) -> List[float]:
    """Per-tenant modeled IPC of one epoch of a multi-tenant replay.

    Tenant *k*'s term finalizes its own masked Stats row under its own
    app profile (arithmetic intensity, contention knee): the IPC it
    would sustain serving its own traffic through the shared cache state
    of the epoch.  This is the per-tenant service quality the QoS
    objectives weigh — unlike a share of the mixed-epoch IPC, it moves
    differently per tenant as the split moves, so weighting a tenant
    actually steers the governor (docs/qos.md).  A tenant with no
    requests in the epoch (idle or departed) scores 0.
    """
    return tenant_epoch_costs(wl, system, nc, nk, lo, hi, delta_rows,
                              seed, counts=counts)[0]


def tenant_epoch_costs(wl, system: str, nc: int, nk: int, lo: int, hi: int,
                       delta_rows: Stats, seed: int = 0,
                       counts: Optional[np.ndarray] = None
                       ) -> Tuple[List[float], List[float]]:
    """Per-tenant modeled (IPC terms, exec times in seconds) of one
    epoch — ``tenant_epoch_ipcs`` plus the time-side view of the same
    finalize: tenant k's exec time over its own masked Stats row is the
    modeled cost of serving its share of the epoch, which is what the
    per-tenant SLO budgeter's ns/request EMA learns from
    (``workloads/serving.py::TenantSLOBudgeter``, docs/qos.md).
    Zero-request tenants score (0 IPC, 0 s)."""
    if counts is None:
        counts = wl.tenant_counts(lo, hi)
    ipcs, times = [], []
    for k, t in enumerate(wl.tenants):
        n_k = int(counts[k])
        row = Stats(*[x[k] for x in delta_rows])
        rr = cs._finalize(cs.RunPoint(t.app, system, nc, nk, n_k, seed),
                          nc, nk, n_k, row)
        ipcs.append(rr.ipc)
        times.append(rr.exec_time_s if n_k > 0 else 0.0)
    return ipcs, times


def qos_reward(gcfg: GovernorConfig, ipcs: Sequence[float],
               counts: Sequence[int]) -> float:
    """Scalar QoS reward from per-tenant IPC terms (docs/qos.md).

    Inactive tenants (zero requests this epoch) are excluded — a
    departed tenant must not pin the min-fairness term to zero or dilute
    the weighted mean.  ``weighted``: convex combination under the
    (renormalized) tenant weights — with one tenant and uniform weights
    this *is* the global epoch reward.  ``minf``: weighted max-min
    fairness, min over active tenants of ``ipc_k / (w_k / max(w))`` —
    uniform weights reduce it to the worst-off tenant's IPC.
    """
    k = len(ipcs)
    w = np.ones(k) if gcfg.tenant_weights is None \
        else np.asarray(gcfg.tenant_weights, float)
    assert len(w) == k, \
        f"tenant_weights has {len(w)} entries for {k} tenants"
    assert np.all(w >= 0), "tenant weights must be non-negative"
    act = np.asarray(counts)[:k] > 0
    if not act.any():
        return 0.0
    w = np.where(act, w, 0.0)
    assert w.sum() > 0, "every active tenant has zero weight"
    x = np.asarray(ipcs, float)
    if gcfg.objective == "weighted":
        return float((w / w.sum() * x).sum())
    # minf: a zero weight means "no fairness claim" — the tenant is
    # excluded from the min instead of dividing by zero
    wtil = w / w.max()
    return float(min(x[i] / wtil[i] for i in np.nonzero(w > 0)[0]))


def _epoch_telemetry(cfg, state, delta: Stats, *,
                     ext_used: Optional[np.ndarray] = None,
                     ext_valid: Optional[np.ndarray] = None,
                     ) -> Tuple[float, float, float]:
    """(ext occupancy, predictor accuracy, BDI bytes saved) of an epoch.

    ``ext_used``/``ext_valid`` may be pre-fetched host copies of the
    state's extended-tier arrays: the fleet reads every replica's
    telemetry back in ONE batched transfer per epoch and passes the
    rows in here, so telemetry costs no per-replica host sync.  By
    default (scalar path) they are read from the device state.
    """
    occupancy = saved = 0.0
    if cfg.ext_enabled:
        used = (state.ext_used[0].cpu().numpy() if ext_used is None
                else np.asarray(ext_used[0]))
        valid = (state.ext_valid[0].cpu().numpy() if ext_valid is None
                 else np.asarray(ext_valid[0]))
        budget = cfg.ext_budget_bytes * max(cfg.amap.ext_sets, 1)
        occupancy = float(used.sum()) / max(budget, 1)
        saved = float(int(valid.sum()) * BLOCK_BYTES - used.sum())
    h = float(np.asarray(delta.ext_hits))
    fp = float(np.asarray(delta.ext_false_pos))
    pm = float(np.asarray(delta.ext_pred_miss))
    acc = (h + pm) / max(h + fp + pm, 1.0)
    return occupancy, acc, saved


class OnlineReplica:
    """One governed (workload, stream position, governor) replica with
    the device step factored out of the loop.

    ``simulate_online``'s prologue and per-epoch epilogue as an explicit
    object: ``epoch_inputs()`` describes the next epoch's trace slice at
    the governor's current split (the arguments of one ``engine.pack``
    call), the caller advances ``state`` through the engine however it
    likes, and ``consume()`` applies the host-side epilogue — flush
    charging, reward, governor observe/decide, warm handoff, telemetry.

    The scalar path (``simulate_online``) advances ONE replica with one
    ``engine.advance_packed`` dispatch per epoch; ``runtime.fleet``
    stacks MANY replicas' state rows into one batched, optionally
    shard_map-sharded dispatch and feeds each replica its row slice.
    Both run exactly this code for everything outside the device step,
    which is what keeps the fleet bit-identical per replica to N scalar
    runs.
    """

    def __init__(self, phases, system: str, *,
                 length: int = 60_000, epoch_len: int = 3_000,
                 window_s: Optional[float] = None,
                 target_epoch: Optional[int] = None,
                 seed: int = 0,
                 gcfg: GovernorConfig = GovernorConfig(),
                 candidates: Optional[Sequence[Split]] = None,
                 fixed_split: Optional[Split] = None,
                 warm_handoff: bool = True,
                 burn_in: Optional[int] = None,
                 log: Optional[TelemetryLog] = None,
                 initial_split: Optional[Split] = None,
                 name: str = "", slo=None, device=None):
        workload = phases if hasattr(phases, "tenants") else None
        spec = cs.SYSTEMS[system]
        ws_scale = 1.0 / cs.SIM_SCALE
        if workload is not None:
            wl = workload
            length = len(wl)
            phase_names = [t.name for t in wl.tenants]
            primary = wl.primary_app
            n_tenants = len(wl.tenants)
            if window_s is None and target_epoch is None:
                epoch_bounds = wl.epoch_bounds(epoch_len=epoch_len)
            else:
                epoch_bounds = wl.epoch_bounds(window_s=window_s,
                                               target_epoch=target_epoch)
            self.masks = wl.tenant_masks()
            self.apps = sorted(t.app for t in wl.tenants)
        else:
            phases = [phases] if isinstance(phases, str) else list(phases)
            phase_names = phases
            primary = next((a for a in phases
                            if tr.WORKLOADS[a].memory_bound), phases[0])
            n_tenants = 1
            from ..workloads.arrivals import epochs_by_count
            epoch_bounds = epochs_by_count(length, epoch_len)
            self.apps = sorted(phases)
        assert gcfg.objective == "global" or workload is not None, \
            "QoS objectives need a composed workloads.Workload"
        if gcfg.tenant_weights is not None:
            assert workload is not None \
                and len(gcfg.tenant_weights) == n_tenants, \
                (f"tenant_weights {gcfg.tenant_weights} does not match "
                 f"the workload's {n_tenants} tenants")
        churn = workload is not None and wl.has_churn()
        if fixed_split is not None:
            cands: List[Split] = [tuple(fixed_split)]        # type: ignore
            gcfg = replace(gcfg, epsilon=0.0, epsilon_min=0.0)
        elif candidates is not None:
            cands = sorted(set(tuple(c)                      # type: ignore
                               for c in candidates))
        else:
            cands = candidates_for(primary, system, length=length)
        initial = None
        if initial_split is not None and len(cands) > 1:
            want = tuple(initial_split)
            initial = cands.index(want) if want in cands else min(
                range(len(cands)), key=lambda j: abs(cands[j][0] - want[0]))
        gov = Governor(cands, gcfg, initial=initial)

        if workload is None:
            # one trace per candidate compute-core count, phase-concat
            trace_of = {}
            for nc in sorted({c[0] for c in cands}):
                trace_of[nc] = tr.generate_phased(phases, n_cores=nc,
                                                  length=length, seed=seed,
                                                  ws_scale=ws_scale)
            self.trace_of = trace_of
            self.bounds = tr.phase_bounds(len(phases), length)

        mean_epoch = max(length // max(len(epoch_bounds), 1), 1)
        if burn_in is None:
            ws_blocks = tr.WORKLOADS[primary].working_set_bytes \
                // cs.SIM_SCALE // tr.BLOCK_BYTES
            burn_in = max(1, int(np.ceil(ws_blocks / mean_epoch)))

        self.system = system
        self.spec = spec
        self.workload = workload
        self.phases = phases
        self.phase_names = phase_names
        self.primary = primary
        self.n_tenants = n_tenants
        self.epoch_bounds = epoch_bounds
        self.churn = churn
        self.gcfg = gcfg
        self.fixed_split = fixed_split
        self.warm_handoff = warm_handoff
        self.seed = seed
        self.burn_in = burn_in
        self.gov = gov
        # optional per-tenant SLO budgeter (workloads/serving.py
        # TenantSLOBudgeter, one instance per replica): when attached to
        # a workload replay, each epoch feeds it the per-tenant modeled
        # costs and the epoch's envelope overrun becomes the governor's
        # overload pressure (docs/qos.md).  None (default) leaves the
        # epilogue byte-identical to the pre-admission replica.
        if slo is not None:
            assert workload is not None, \
                "per-tenant SLO budgeter needs a composed Workload"
            assert set(slo.names) == {t.name for t in wl.tenants}, \
                (f"budgeter tenants {slo.names} do not match workload "
                 f"tenants {[t.name for t in wl.tenants]}")
        self.slo = slo
        self.name = name or f"{system}:{'+'.join(phase_names)}#{seed}"
        self.log = log if log is not None else TelemetryLog()
        self.records: List[EpochRecord] = []
        self.device = engine.resolve_device(device)
        self.state = engine.init_state(
            cs.build_config(spec, gov.current[1]), n_tenants, self.device)
        self.total_stats = None
        self.pending_flush = None    # last transition's flush -> next epoch
        self.epoch_i = 0
        self.t_all = 0.0
        self.insts_all = 0.0
        self.t_steady = 0.0
        self.insts_steady = 0.0
        self._cur = None             # epoch_inputs() -> consume() handshake
        self._dec_seen = 0           # gov.decisions already attributed

    @property
    def done(self) -> bool:
        return self.epoch_i >= len(self.epoch_bounds)

    @property
    def mix_key(self) -> Tuple:
        """What the split-advisor considers "the same mix": system spec +
        the (sorted) set of apps the replica serves."""
        return (self.system, tuple(self.apps))

    def epoch_inputs(self):
        """(cfg, traces, pos0, count) for the next epoch at the
        governor's current split — the arguments of one ``engine.pack``
        call.  Read-only: calling it again before ``consume`` describes
        the same epoch."""
        assert not self.done, "replica already finished"
        lo, hi = self.epoch_bounds[self.epoch_i]
        nc, nk = self.gov.current
        cfg = cs.build_config(self.spec, nk)
        if self.workload is not None:
            wl = self.workload
            addrs, writes, levels = wl.addrs, wl.writes, wl.levels
            count = [m[lo:hi] for m in self.masks] \
                if self.n_tenants > 1 else None
        else:
            addrs, writes, levels = self.trace_of[nc]
            count = None
        traces = [(addrs[lo:hi], writes[lo:hi], levels[lo:hi], 0)] \
            * self.n_tenants
        self._cur = (lo, hi, nc, nk, cfg)
        return cfg, traces, [lo] * self.n_tenants, count

    def consume(self, state, delta_rows: Stats, *,
                ext_used: Optional[np.ndarray] = None,
                ext_valid: Optional[np.ndarray] = None,
                host_state=None) -> None:
        """Epilogue of the epoch last described by ``epoch_inputs``.

        ``state`` is the advanced ``EngineState`` (this replica's rows);
        ``delta_rows`` the epoch's Stats delta with numpy leaves of
        shape (n_tenants,).  ``ext_used``/``ext_valid`` are optional
        pre-fetched host copies of the state's extended-tier telemetry
        (rows of this replica) — the fleet passes them so telemetry
        needs no per-replica device sync.  ``host_state`` is an optional
        pre-fetched host copy of the *whole* state, used only by the
        cache-content inspector (the fleet batches it into the same
        single transfer when introspection is on).
        """
        assert self._cur is not None, "consume() without epoch_inputs()"
        lo, hi, nc, nk, cfg = self._cur
        self._cur = None
        gov, gcfg = self.gov, self.gcfg
        workload = wl = self.workload
        system, seed = self.system, self.seed
        self.state = state
        delta = Stats(*[x.sum(axis=0) for x in delta_rows])
        t_counts = wl.tenant_counts(lo, hi) if workload is not None \
            else None
        if self.pending_flush is not None:
            # the previous transition's flush writebacks are real
            # traffic: charge them to this epoch so the reward, exec
            # time and the aggregate IPC all pay for the switch (handoff
            # also charges them on the carried state.stats)
            delta = Stats(*[np.add(x, f) for x, f in
                            zip(delta, self.pending_flush)])
            if workload is not None:
                # the per-tenant reward rows must pay too, or a QoS
                # objective would see switches as free and lose the
                # thrashing disincentive; apportion by request share
                # (reward attribution only — the carried per-tenant
                # stats are charged exactly via _attribute_flush)
                shares = t_counts / max(int(t_counts.sum()), 1)

                def _apportion(rows, f):
                    if np.issubdtype(rows.dtype, np.floating):
                        return (rows + float(f) * shares).astype(rows.dtype)
                    return rows
                delta_rows = Stats(*[_apportion(r, f) for r, f in
                                     zip(delta_rows, self.pending_flush)])
            self.pending_flush = None
        self.total_stats = delta if self.total_stats is None else \
            Stats(*[np.add(t, x) for t, x in zip(self.total_stats, delta)])
        n_req = hi - lo
        tenant_ipc: Optional[List[float]] = None
        if workload is not None:
            app = wl.app_at(lo, hi)
            insts = wl.instructions(lo, hi)
            rr = cs._finalize(cs.RunPoint(app, system, nc, nk, n_req,
                                          seed),
                              nc, nk, n_req, delta, insts=insts,
                              knee=wl.contention_knee(lo, hi))
            tenant_ipc, tenant_t = tenant_epoch_costs(
                wl, system, nc, nk, lo, hi, delta_rows, seed,
                counts=t_counts)
        else:
            app = self.phases[int(np.searchsorted(self.bounds, lo,
                                                  side="right"))]
            insts = tr.instructions_for(app, n_req)
            rr = cs._finalize(cs.RunPoint(app, system, nc, nk, n_req,
                                          seed),
                              nc, nk, n_req, delta)
        if workload is not None and gcfg.objective != "global":
            reward = qos_reward(gcfg, tenant_ipc, t_counts)
        else:
            reward = rr.ipc
        self.t_all += rr.exec_time_s
        self.insts_all += insts
        if self.epoch_i >= self.burn_in:
            self.t_steady += rr.exec_time_s
            self.insts_steady += insts

        occ, acc, saved = _epoch_telemetry(cfg, state, delta,
                                           ext_used=ext_used,
                                           ext_valid=ext_valid)
        # fairness audit: Jain's index over the ACTIVE tenants' IPC terms
        # (departed tenants excluded, like the QoS reward).  Always
        # computed — a handful of host float ops — so the telemetry
        # column is identical with obs on or off.
        if tenant_ipc is None:
            fairness = 1.0
        else:
            fairness = jains_index([x for x, c in zip(tenant_ipc, t_counts)
                                    if c > 0])
        if obs.metrics_on():
            obs.set_gauge("fairness_jain", fairness, replica=self.name)
        # cache microscope: decode the epoch's end-state into a content
        # snapshot.  Captured BEFORE the governor decides — a switch
        # below replaces the state under a new geometry, and the
        # snapshot must describe the state the epoch actually ran on.
        ins = obs.inspector()
        if ins is not None and ins.wants(self.epoch_i):
            from ..obs import inspect as obs_inspect
            dec = engine.decode_state(
                cfg, state if host_state is None else host_state)
            stride, names = 0, None
            if workload is not None:
                from ..workloads.tenancy import TENANT_STRIDE_BLOCKS
                stride = TENANT_STRIDE_BLOCKS
                names = [t.name for t in wl.tenants]
            tot = self.total_stats
            ins.record(obs_inspect.snapshot_from_decode(
                dec, epoch=self.epoch_i, replica=self.name,
                conv_ways=cfg.conv_ways, ext_max_ways=cfg.ext_max_ways,
                ext_budget_bytes=cfg.ext_budget_bytes,
                block_bytes=tr.BLOCK_BYTES, tenant_stride=stride,
                tenant_names=names,
                probe_counters=(int(np.asarray(tot.ext_false_pos)),
                                int(np.asarray(tot.ext_pred_miss)))))
            obs.count("state_snapshots", 1, path="online")
        # bottleneck direction: the runtime sees which term binds (stall
        # counters in a real system; the roofline terms here).  Compute-
        # bound => more compute cores can help (+1); a full extended
        # tier on a memory-bound epoch => more cache capacity (-1).
        t_comp = insts / (nc * cs.IPC_PER_CORE * cs.FREQ_GHZ * 1e9)
        if t_comp >= 0.99 * rr.exec_time_s:
            hint = +1
        elif occ > 0.9:
            hint = -1
        else:
            hint = 0
        if self.churn:
            # churn boundary = active-tenant signature change: context
            # reset (estimates describe a departed mix) + phase keys
            # scoped to the new mix; a remembered mix is jumped to on
            # the next decide()
            gov.set_context(wl.active_signature(lo, hi))
        pressure = 0.0
        if self.slo is not None:
            # per-tenant SLO closed loop: the budgeter learns each
            # tenant's modeled cost from its masked row, and the epoch's
            # overrun of the joint SLO envelope (the tightest active
            # SLO) becomes the governor's overload pressure
            round_ms = rr.exec_time_s * 1e3
            names = [t.name for t in wl.tenants]
            self.slo.observe(
                {n: int(c) for n, c in zip(names, t_counts)}, round_ms,
                {n: tenant_t[k] * 1e9 / int(t_counts[k])
                 for k, n in enumerate(names) if int(t_counts[k]) > 0})
            active = [n for n, c in zip(names, t_counts) if int(c) > 0]
            if active and round_ms > 0:
                pressure = round_ms / self.slo.round_ms(active)
        gov.observe(reward, hint, signature=rr.llc_hit_rate,
                    pressure=pressure)
        eps = gov.eps
        new_split = gov.decide() if self.fixed_split is None \
            else gov.current
        flush_wbs = 0
        if new_split != (nc, nk):
            new_cfg = cs.build_config(self.spec, new_split[1])
            if new_cfg != cfg:
                state, rep = rt_stream.handoff(cfg, state, new_cfg,
                                               migrate=self.warm_handoff)
                state = _attribute_flush(state, rep, workload, cfg)
                self.state = state
                flush_wbs = rep.flush_writebacks // self.n_tenants
                if flush_wbs:
                    e_dram = rt_stream.flush_energy_nJ_per_block(cfg)
                    z = Stats(*[np.zeros((), np.asarray(x).dtype)
                                for x in delta])
                    self.pending_flush = z._replace(
                        writebacks=np.int32(flush_wbs),
                        dram_bytes=np.float32(flush_wbs * tr.BLOCK_BYTES),
                        energy_nJ=np.float32(flush_wbs * e_dram))
        # decision provenance epilogue: attribute this epoch's events to
        # the replica, charge the switch event its flush cost, and emit
        # them as trace instants when tracing is on (obs side channel —
        # none of this feeds back into the governor)
        new_events = gov.decisions[self._dec_seen:]
        self._dec_seen = len(gov.decisions)
        for ev in new_events:
            ev.replica = self.name
            if flush_wbs and ev.switched:
                ev.flush_writebacks = flush_wbs
            # cache-state summary at decision time: numbers the epilogue
            # already computed, so the event is bit-identical obs on/off
            ev.summary = {"hit_rate": rr.llc_hit_rate, "ext_occupancy": occ,
                          "pred_accuracy": acc, "fairness": fairness,
                          "reward": reward}
            obs.instant("governor.decision", **ev.to_dict())
        obs.count("epochs", 1, path="online")
        rec = EpochRecord(
            epoch=self.epoch_i, pos=lo, app=app, n_compute=nc,
            n_cache=nk, requests=n_req,
            hit_rate=rr.llc_hit_rate, ext_occupancy=occ,
            pred_accuracy=acc, bytes_saved=saved, ipc=rr.ipc,
            exec_time_s=rr.exec_time_s,
            reward=reward, switched=gov.last_switched,
            flush_writebacks=flush_wbs, epsilon=eps,
            tenants="" if workload is None else "|".join(
                f"{t.name}:{c}" for t, c in zip(wl.tenants, t_counts)),
            tenant_ipc="" if tenant_ipc is None else "|".join(
                f"{t.name}:{x:.4f}"
                for t, x in zip(wl.tenants, tenant_ipc)),
            fairness=fairness,
            decision=";".join(ev.compact() for ev in new_events))
        self.records.append(rec)
        self.log.append(rec)
        self.epoch_i += 1

    def result(self) -> OnlineResult:
        """Aggregate the finished run (callable once ``done``)."""
        gov, records, workload = self.gov, self.records, self.workload
        freq = cs.FREQ_GHZ * 1e9
        ipc = self.insts_all / (self.t_all * freq) if self.t_all > 0 \
            else 0.0
        steady = self.insts_steady / (self.t_steady * freq) \
            if self.t_steady > 0 else ipc
        post = records[self.burn_in:] or records
        dwelt = Counter((r.n_compute, r.n_cache) for r in post)
        converged_split = max(dwelt, key=lambda s: dwelt[s])
        conv_recs = [r for r in post
                     if (r.n_compute, r.n_cache) == converged_split]
        t_conv = sum(r.exec_time_s for r in conv_recs)
        # per-epoch ipc = insts / (t * freq), so insts = ipc * t * freq:
        # exact for both the phased and mixed-tenant reward paths
        insts_conv = sum(r.ipc * r.exec_time_s for r in conv_recs) * freq
        converged = insts_conv / (t_conv * freq) if t_conv > 0 else steady
        tenant_stats = None
        if workload is not None:
            host = [x.cpu().numpy() for x in self.state.stats]
            tenant_stats = {t.name: Stats(*[x[k] for x in host])
                            for k, t in enumerate(workload.tenants)}
        return OnlineResult(
            system=self.system, phases=self.phase_names, records=records,
            log=self.log, stats=self.total_stats, ipc=ipc,
            steady_ipc=steady, converged_ipc=converged,
            exec_time_s=self.t_all, switches=gov.switches,
            final_split=gov.current, converged_split=converged_split,
            churn_resets=gov.churn_resets, tenant_stats=tenant_stats,
            decisions=list(gov.decisions))


def simulate_online(phases, system: str, *,
                    length: int = 60_000, epoch_len: int = 3_000,
                    window_s: Optional[float] = None,
                    target_epoch: Optional[int] = None,
                    seed: int = 0, device=None,
                    gcfg: GovernorConfig = GovernorConfig(),
                    candidates: Optional[Sequence[Split]] = None,
                    fixed_split: Optional[Split] = None,
                    warm_handoff: bool = True,
                    burn_in: Optional[int] = None,
                    log: Optional[TelemetryLog] = None) -> OnlineResult:
    """Run the online Morpheus runtime against the trace simulator.

    ``phases`` is one app, a sequence of apps replayed back to back
    (equal shares of ``length``), or a composed multi-tenant
    ``repro.workloads.Workload``.

    In the *phased* form each phase keeps its own working set, so phase
    boundaries shift the request mix under the governor; one trace is
    generated per candidate compute-core count (the request interleaving
    depends on how many cores compute) and the stream reads the current
    split's trace — exactly the feedback a real mode switch has on the
    LLC stream.

    In the *workload* form the request stream is a recorded artifact
    (tenant traces merged by arrival time): it does not re-interleave
    when the split changes, epochs follow the workload's arrival
    timestamps (``window_s``/``target_epoch``: variable-size epochs under
    bursty arrivals; default fixed ``epoch_len`` chunks), the reward model
    uses the epoch's exact request-weighted instruction mix, and the
    engine carries one masked state row per tenant so the result reports
    exact per-tenant Stats (``OnlineResult.tenant_stats``) — including
    flush charges attributed to the tenant owning each flushed block.

    ``fixed_split`` disables the governor (static-baseline mode).
    Aggregate IPC is time-weighted over epochs; ``steady_ipc`` skips the
    first ``burn_in`` epochs (default: one working-set fill).

    This is the scalar driver over ``OnlineReplica``: one engine dispatch
    per epoch, on ``device`` (None: the CUDA card, ``BackendError``
    without one; ``"cpu"``: the plain versions).  With tracing on, the
    replica's construction (trace generation), each epoch's ``pack``,
    ``advance_packed`` with the read-back of its Stats, and the host
    epilogue (governor, handoff, telemetry) are spans.
    """
    dev = engine.resolve_device(device)
    with obs.span("online.replica"):
        rep = OnlineReplica(phases, system, length=length,
                            epoch_len=epoch_len, window_s=window_s,
                            target_epoch=target_epoch, seed=seed, gcfg=gcfg,
                            candidates=candidates, fixed_split=fixed_split,
                            warm_handoff=warm_handoff, burn_in=burn_in,
                            log=log, device=dev)
    while not rep.done:
        with obs.span("online.pack"):
            cfg, traces, pos0, count = rep.epoch_inputs()
            pt = engine.pack(cfg, traces, pos0=pos0, count=count)
        with obs.span("online.advance"):
            state, delta_b = engine.advance_packed(cfg, pt, rep.state, dev)
            host = Stats(*[x.cpu().numpy() for x in delta_b])
        if obs.metrics_on():
            obs.count("device_get_bytes", sum(x.nbytes for x in host))
        with obs.span("online.consume"):
            rep.consume(state, host)
    return rep.result()


def _attribute_flush(state, rep: rt_stream.HandoffReport, workload,
                     cfg) -> EngineState:
    """Re-attribute a handoff's flush charges to the owning tenants.

    ``handoff`` charged EVERY state row the full replica flush (the rows
    replay identical requests, so each sees the same resident blocks).
    For a K-tenant state the global view must count the flush once, and
    each tenant row should only pay for the dirty blocks in its own
    address region — recoverable exactly because tenant regions are
    disjoint (``addr // TENANT_STRIDE_BLOCKS``).
    """
    if workload is None or len(workload.tenants) <= 1 \
            or rep.flush_writebacks == 0:
        return state
    from ..workloads.tenancy import TENANT_STRIDE_BLOCKS
    k = len(workload.tenants)
    per = rep.flush_writebacks // k          # identical rows: exact
    tids = (np.asarray(rep.dropped_dirty_addr, np.uint64)
            // np.uint64(TENANT_STRIDE_BLOCKS)).astype(np.int64)
    wbs_k = np.bincount(tids, minlength=k)[:k].astype(np.int64)
    corr = (per - wbs_k)                     # over-charge to remove per row
    e_dram = rt_stream.flush_energy_nJ_per_block(cfg)
    dev = state.pos.device
    stats = Stats(*[x.cpu().numpy().copy() for x in state.stats])
    stats = stats._replace(
        writebacks=(stats.writebacks - corr).astype(np.int32),
        dram_bytes=(stats.dram_bytes
                    - (corr * tr.BLOCK_BYTES)).astype(np.float32),
        energy_nJ=(stats.energy_nJ - (corr * e_dram)).astype(np.float32))
    return state._replace(stats=Stats(*[torch.from_numpy(x).to(dev)
                                        for x in stats]))
