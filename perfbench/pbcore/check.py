"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference that the configuration names
(``reference/<name>.py``), run after the window once the program's state
is freed, on weights and inputs the benchmark draws again from the seed.

Serving: a sample of the window's batches drawn from the seed as they
are served (``Sample``: only the sample's logits stay on the card), the
reference's logits at every served position, teacher-forced on the
served tokens, against the logits the program produced there (kept as
the timed path returned them).  Each position reads the largest logit
error over the row's scale.  Compared, as the cell's limits file lists
them: ``logit_err``, the median over all positions; ``req_err``, the
mean over the requests of each request's median, which a fault confined
to one slot of a batch moves while a routing flip at a few positions of
one request does not; ``logit_err_max``, the largest over all positions
(dense models only); and the served tokens that are
not the argmax of the program's own logits (none).  The widest gap by
which a served token's logit lies below the reference's best
(``serve_readings`` reads it for ``calibrate.py``) is not compared, nor
is ``logit_err_max`` of an MoE model: a top-k routing decision of the
MoE layer that flips on a near tie under another order of f32 sums moves
a token's logits by up to a tenth of their scale, so sound runs read
gaps as wide as the TF32 control's (PERF.md), and TF32 moves a dense
model's logits too little to flip its greedy tokens on every seed.

Training: the first ``CHECKED_STEPS`` steps of the window's own step
object on the feed's batches, against the reference's steps on the same
batches: each step's loss (relative gap), each leaf's norm of the first
gradient as the optimizer took it (after clipping; the program's worked
out from its first moment after step 1), and each leaf's norm of the
parameters' change over the checked steps, both by the worst leaf:
|program - reference| over the larger of the reference's leaf norm and
its median leaf's.  A leaf whose reference gradient is under
``TINY_GRAD`` of the median leaf's is left out of both.

Each number is held to its limit in ``limits/<cell>.json``.
"""
from __future__ import annotations

import importlib
from statistics import median
from typing import Dict, List

import numpy as np
import torch

from . import traffic
from . import weights as W

CHECKED_STEPS = 3
TINY_GRAD = 1e-3


def reference_of(cfg: dict):
    """The plain reference module that the configuration names."""
    return importlib.import_module(f"reference.{cfg['reference']}")


class Sample:
    """The batches the reference checks, chosen from the seed as they are
    served: batch ``k`` of the window has a priority drawn from the seed,
    and the sample is the batches of lowest priority whose served tokens
    reach ``need``.  ``wants(k)`` says whether batch ``k`` can still
    enter it, so that one which cannot keeps no logits; ``offer`` drops
    the logits of the batches it pushes out."""

    def __init__(self, seed: int, need: int):
        self.key, self.need = W.sub_seed(seed, "check"), need
        self.kept: list = []            # (priority, round), ascending

    def _priority(self, k: int) -> float:
        return float(np.random.default_rng([self.key, k]).random())

    def _tokens_below(self, p: float) -> int:
        return sum(sum(len(o) for o in r.out) for q, r in self.kept if q < p)

    def wants(self, k: int) -> bool:
        return self._tokens_below(self._priority(k)) < self.need

    def offer(self, k: int, rnd) -> None:
        self.kept.append((self._priority(k), rnd))
        self.kept.sort(key=lambda e: e[0])
        while len(self.kept) > 1 and self._tokens_below(
                self.kept[-1][0]) >= self.need:
            self.kept.pop()[1].logits = None


def _position_errors(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, new): each served position's largest logit error over the
    row's scale, max |prog - ref| / max |ref|."""
    return ((prog - ref).abs().amax(-1)
            / ref.abs().amax(-1).clamp_min(1e-30))


def serve_readings(ctx, rounds, tf32: bool = False) -> dict:
    """The program's served ``rounds`` (their tokens ``out`` and the logits
    ``logits`` (B, new, V) that produced them) against the reference's
    logits at the same positions: ``logit_err`` the median over the
    positions of ``_position_errors``, its 90th percentile and largest,
    ``req_err`` the mean over the requests of each one's median
    (``req_err_max`` the largest, ``req_errs`` all, largest first), ``token_mismatch`` the
    served tokens that are not the argmax of the program's own logits,
    ``served_gap`` the widest gap by which a served token's logit lies
    below the reference's best.  With ``tf32`` the control's too: the
    reference in TF32 read as the program is (``control_*``)."""
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    R = reference_of(cfg)
    plen = ctx.mix["prompt_tokens"]
    batches = [torch.tensor([list(q.prompt) + o[:-1]
                             for q, o in zip(r.reqs, r.out)],
                            dtype=torch.long, device=dev) for r in rounds]
    served = [torch.tensor(r.out, dtype=torch.long, device=dev)
              for r in rounds]

    def reference(on: bool):
        R.set_tf32(on)
        try:
            return R.served_logits(
                cfg, W.draw_top(cfg, seed, dev),
                lambda li: W.draw_layer(cfg, seed, li, dev), batches, plen)
        finally:
            R.set_tf32(False)

    def read(got, ref, prefix=""):
        errs = [_position_errors(g.float(), f).double()
                for g, f in zip(got, ref)]
        err = torch.cat([e.reshape(-1) for e in errs])
        per_req = torch.cat([e.quantile(0.5, dim=-1) for e in errs])
        gap = max(float((f.max(-1).values - f.gather(
            -1, g.argmax(-1, keepdim=True))[..., 0]).max())
            for g, f in zip(got, ref))
        q = torch.quantile(err, torch.tensor(
            [0.5, 0.9], dtype=torch.float64, device=err.device))
        return {prefix + "logit_err": float(q[0]),
                prefix + "logit_err_p90": float(q[1]),
                prefix + "logit_err_max": float(err.max()),
                prefix + "req_err": float(per_req.mean()),
                prefix + "req_err_max": float(per_req.max()),
                prefix + "req_errs": sorted(per_req.tolist(), reverse=True),
                prefix + "served_gap": gap}

    ref = reference(False)
    progs = [r.logits for r in rounds]
    out = read(progs, ref)
    out["token_mismatch"] = sum(int((p.argmax(-1) != s).sum())
                                for p, s in zip(progs, served))
    out["tokens"] = sum(int(s.numel()) for s in served)
    if tf32:
        out.update(read(reference(True), ref, "control_"))
    return out


def served(ctx, rounds) -> Dict[str, dict]:
    """The checks of a serving run: each number that the cell's limits
    file names, over the batches of the window that kept their logits
    (``Sample``)."""
    new = ctx.mix["new_tokens"]
    short = sum(1 for r in rounds for o in r.out if len(o) != new)
    sample = [r for r in rounds if r.logits is not None]
    r = serve_readings(ctx, sample) if sample else {}
    out = {k: {"value": r.get(k), "limit": lim}
           for k, lim in ctx.limits.items()}
    out.update({
        "token_mismatch": {"value": r.get("token_mismatch"), "limit": 0},
        "short_answers": {"value": short, "limit": 0},
        "checked_tokens": {"value": r.get("tokens", 0),
                           "limit": ctx.mix["check_tokens"],
                           "at_least": True}})
    return out


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           keep: List[str]) -> float:
    floor = median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in keep)


def reference_train(ctx, tf32: bool = False) -> dict:
    """The reference's checked steps on the seed's weights and batches (in
    TF32 with ``tf32``: the control): each step's loss, each leaf's norm
    of the first gradient after clipping, and of the change."""
    cfg, mix, dev, seed = ctx.config, ctx.mix, ctx.device, ctx.seed
    params = {f"layers.{li}.{k}": v for li in range(cfg["num_layers"])
              for k, v in W.draw_layer(cfg, seed, li, dev).items()}
    params.update(W.draw_top(cfg, seed, dev))
    R = reference_of(cfg)
    R.set_tf32(tf32)
    try:
        ref = R.TrainReference(cfg, mix["optimizer"], params)
        losses, grads = [], None
        for k in range(CHECKED_STEPS):
            out = ref.step(traffic.train_batch(mix, cfg["vocab_size"], seed,
                                               k, dev))
            losses.append(out["loss"])
            grads = grads or out["grad_norms"]
    finally:
        R.set_tf32(False)
    change = change_norms(ref.params, cfg, seed, dev)
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def compare_train(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of ``prog``'s readings against ``ref``'s."""
    grads = ref["grad_norms"]
    floor = median(grads.values())
    keep = [n for n, g in grads.items() if g >= TINY_GRAD * floor]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _worst(prog["grad_norms"], grads, keep),
        "change_gap": _worst(prog["change_norms"], ref["change_norms"], keep),
        "left_out": len(grads) - len(keep)}


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor], cfg: dict, seed: int,
                 device) -> Dict[str, float]:
    """Each leaf's norm of its change from the seeded weights."""
    out = {}
    for li in range(cfg["num_layers"]):
        for k, v in W.draw_layer(cfg, seed, li, device).items():
            n = f"layers.{li}.{k}"
            out[n] = float(torch.linalg.vector_norm(params[n].detach() - v))
    for k, v in W.draw_top(cfg, seed, device).items():
        out[k] = float(torch.linalg.vector_norm(params[k].detach() - v))
    return out


def trained(ctx, prog: dict) -> Dict[str, dict]:
    lim = ctx.limits
    r = compare_train(prog, reference_train(ctx))
    return {k: {"value": r[k], "limit": lim[k]}
            for k in ("loss_gap", "grad_gap", "change_gap")}


def passed(checks: Dict[str, dict]) -> bool:
    for c in checks.values():
        v = c["value"]
        if v is None or not np.isfinite(v):
            return False
        if c.get("at_least"):
            if v < c["limit"]:
                return False
        elif v > c["limit"]:
            return False
    return True
