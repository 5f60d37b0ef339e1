"""The search loop: agent proposals -> one batched evaluation -> log.

After ``repro.autotune.tuner`` (numpy only, copied and held identical).

Trajectory discipline (the part worth being strict about):

  * Every run appends ONE JSONL line per generation plus a header line,
    serialized with ``sort_keys`` and fixed separators and **no
    timestamps or paths** — so the file is a pure function of
    (space, agent, seed, objective) and two runs produce byte-identical
    bytes.  The golden test pins a crc32 across fresh processes.
  * Configs are logged as index *keys* into the space (ints, not knob
    values), so float knob values can never pick up repr drift.
  * ``resume=True`` replays the existing file: the agent's ``propose``
    is re-run against each logged generation and must reproduce it
    exactly (a loud ``TrajectoryError`` otherwise), the logged scores
    are fed to ``observe`` without re-evaluating, and the search
    continues live from where the file ends.  Replay costs zero
    simulator dispatches.

``best_configs.json`` is the ArchGym-style artifact: per-agent winner
configs + scores for one search target, written by the benchmarks and
consumed by humans deciding what to pin.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .. import obs
from .agents import SearchAgent, make_agent
from .space import Config, SearchSpace

_JSON_KW = dict(sort_keys=True, separators=(",", ":"))


class TrajectoryError(RuntimeError):
    """A trajectory file contradicts the (space, agent, seed) replaying
    it — wrong header, or an agent proposing differently than logged."""


def _dumps(obj) -> str:
    return json.dumps(obj, **_JSON_KW) + "\n"


@dataclass
class Generation:
    gen: int
    keys: List[tuple]           # proposed configs, encoded
    scores: List[float]
    best_key: tuple             # best so far (monotone)
    best_score: float

    def record(self) -> Dict:
        return {"kind": "generation", "gen": self.gen,
                "keys": [list(k) for k in self.keys],
                "scores": self.scores,
                "best_key": list(self.best_key),
                "best_score": self.best_score}


@dataclass
class TunerResult:
    best_config: Config
    best_score: float
    history: List[Generation]
    evaluations: int            # configs scored live (not replayed)
    replayed: int               # generations restored from trajectory

    def best_curve(self) -> List[float]:
        """Best-so-far score per generation (the regret curve's y)."""
        return [g.best_score for g in self.history]


class Tuner:
    """Drive one agent against one objective, logging every generation.

    ``objective`` needs ``evaluate(configs) -> scores`` (one batched
    dispatch) and optionally ``describe()`` for the trajectory header.
    ``trajectory_path=None`` runs in memory (tests, throwaway searches).
    """

    def __init__(self, space: SearchSpace, objective, agent: SearchAgent,
                 trajectory_path: Optional[Path] = None):
        self.space = space
        self.objective = objective
        self.agent = agent
        self.path = Path(trajectory_path) if trajectory_path else None

    # ------------------------------------------------------------ header
    def _header(self) -> Dict:
        desc = self.objective.describe() \
            if hasattr(self.objective, "describe") else {}
        return {"kind": "header", "version": 1,
                "agent": self.agent.name, "pop": self.agent.pop,
                "seed": self.agent.seed,
                "space": self.space.describe(), "objective": desc}

    # ------------------------------------------------------------ replay
    def _replay(self) -> List[Generation]:
        lines = self.path.read_text().splitlines()
        if not lines:
            return []
        head = json.loads(lines[0])
        want = self._header()
        if head != want:
            raise TrajectoryError(
                f"trajectory header mismatch:\n  file: {head}\n"
                f"  this run: {want}")
        history: List[Generation] = []
        for line in lines[1:]:
            rec = json.loads(line)
            proposed = self.agent.propose()
            keys = [list(self.space.encode(c)) for c in proposed]
            if keys != rec["keys"]:
                raise TrajectoryError(
                    f"replay diverged at generation {rec['gen']}: agent "
                    f"proposed {keys}, trajectory logged {rec['keys']} — "
                    f"the agent is not a pure function of (seed, scores)")
            self.agent.observe(proposed, rec["scores"])
            history.append(Generation(
                gen=rec["gen"], keys=[tuple(k) for k in rec["keys"]],
                scores=[float(s) for s in rec["scores"]],
                best_key=tuple(rec["best_key"]),
                best_score=float(rec["best_score"])))
        return history

    # --------------------------------------------------------------- run
    def run(self, generations: int, *, resume: bool = False) -> TunerResult:
        history: List[Generation] = []
        replayed = 0
        if resume and self.path is not None and self.path.exists() \
                and self.path.stat().st_size > 0:
            history = self._replay()
            replayed = len(history)
            fh = self.path.open("a") if self.path else None
        else:
            fh = None
            if self.path is not None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fh = self.path.open("w")
                fh.write(_dumps(self._header()))
        evaluations = 0
        try:
            for g in range(len(history), generations):
                with obs.span("tuner.generation", gen=g,
                              agent=self.agent.name) as sp:
                    configs = self.agent.propose()
                    scores = [float(s) for s in
                              self.objective.evaluate(configs)]
                    evaluations += len(configs)
                    self.agent.observe(configs, scores)
                    gen = Generation(
                        gen=g,
                        keys=[self.space.encode(c) for c in configs],
                        scores=scores,
                        best_key=self.space.encode(self.agent.best),
                        best_score=float(self.agent.best_score))
                    sp.set(evaluated=len(configs),
                           best_score=gen.best_score)
                obs.count("tuner_evaluations", len(configs))
                history.append(gen)
                if fh is not None:
                    fh.write(_dumps(gen.record()))
                    fh.flush()
        finally:
            if fh is not None:
                fh.close()
        return TunerResult(best_config=dict(self.agent.best),
                           best_score=float(self.agent.best_score),
                           history=history, evaluations=evaluations,
                           replayed=replayed)


# ------------------------------------------------------------- utilities

def trajectory_crc(path: Path) -> int:
    """crc32 of the raw trajectory bytes — the golden-pin primitive."""
    return zlib.crc32(Path(path).read_bytes())


def read_trajectory(path: Path) -> Dict:
    """Parse a trajectory file into {header, generations}."""
    lines = Path(path).read_text().splitlines()
    assert lines, f"empty trajectory {path}"
    head = json.loads(lines[0])
    assert head.get("kind") == "header", f"no header in {path}"
    return {"header": head,
            "generations": [json.loads(ln) for ln in lines[1:]]}


def replay_agent(path: Path) -> SearchAgent:
    """Rebuild (space, agent) from a trajectory header and replay every
    logged generation through ``propose``/``observe``, verifying the
    proposals — the determinism check behind ``tools/autotune_trajectory.py
    verify``.  Returns the agent in its end-of-file state."""
    doc = read_trajectory(path)
    head = doc["header"]
    space = SearchSpace.from_description(head["space"])
    agent = make_agent(head["agent"], space, seed=head["seed"],
                       pop=head["pop"])
    for rec in doc["generations"]:
        proposed = agent.propose()
        keys = [list(space.encode(c)) for c in proposed]
        if keys != rec["keys"]:
            raise TrajectoryError(
                f"verify failed at generation {rec['gen']}: proposals "
                f"{keys} != logged {rec['keys']}")
        agent.observe(proposed, rec["scores"])
    return agent


def write_best_configs(path: Path, target: str, space: SearchSpace,
                       records: Sequence[Dict]) -> Path:
    """The ``best_configs.json`` artifact: one search target, every
    agent's winner.  ``records`` rows come from ``TunerResult`` +
    context, e.g. ``{"agent": "hill", "best_config": {...},
    "best_score": 1.02, "generations": 6, "seed": 0}``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"version": 1, "target": target, "space": space.describe(),
           "results": sorted(records, key=lambda r: -r["best_score"])}
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return path
