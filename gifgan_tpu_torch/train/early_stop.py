"""Quality-plateau early stopping + best-checkpoint retention: the port's
copy of gifgan_tpu/train/early_stop.py (a host policy over eval records,
no tensor in it).

Evidence base (docs/ENDURANCE.md, runs 3-4): endurance run 3's track-rate
proxy DECLINED in its second hour under a saturated D (29/32 @96k ->
21/32 @120k -> 24/32 @132k; final 86.7%), and run 4 finished at 100% with
half run 3's budget — on this recipe the productive training happens in
the first ~50-70k steps, after which quality drifts. Long runs should
therefore stop on a track-rate/FAD plateau rather than a wall-clock
budget, and the artifact worth keeping is the BEST periodic eval's
checkpoint, not the last one.

This is a host-side policy over the periodic eval records the endurance
loop already emits (the face-track-rate proxy + optional FAD). The
reference has no equivalent: its runs trained to a fixed epoch count with
a human watching sample grids (model.py:250-263) — this automates the
"the samples stopped getting better, stop the run" judgement the same way
train/controller.py automates the collapse intervention.

Improvement ordering (higher is better):
  1. track-rate strictly up => new best (the proxy is quantized at
     1/eval_clips, so any strict increase exceeds one quantum of noise);
  2. track-rate tied AND FAD down by more than `fad_tie_delta` => new best
     (at a saturated 100% rate — run 4 — FAD is the only live signal);
  3. with no detector (rate None), FAD down alone counts.

After `patience` consecutive non-improving evals (never before
`warmup_evals` total), the policy says stop. All state is replayable from
the run's JSONL log, so kill -9/resume keeps best-so-far and
evals-since-best exactly (see `replay_eval_log`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class EarlyStopConfig:
    patience: int = 4        # consecutive non-improving evals before stop
    warmup_evals: int = 3    # never stop before this many evals total
    fad_tie_delta: float = 0.0  # FAD must drop by MORE than this to break
    #                            a rate tie (0 = any strict improvement)


@dataclasses.dataclass
class QualityEarlyStop:
    """observe(rate, fad, ...) once per periodic eval -> event dict or None.

    Events: {"kind": "quality_best", ...} on a new best (caller should
    snapshot the checkpoint), {"kind": "early_stop", ...} when the plateau
    patience is exhausted. The policy is inert once stopped.
    """

    config: EarlyStopConfig = dataclasses.field(
        default_factory=EarlyStopConfig)

    # mutable policy state (all recoverable via replay_eval_log)
    best_rate: Optional[float] = None
    best_fad: Optional[float] = None
    best_chunk: Optional[int] = None
    best_step: Optional[int] = None
    evals: int = 0
    since_best: int = 0
    stopped: bool = False

    def _improved(self, rate: Optional[float], fad: Optional[float]) -> bool:
        if rate is not None:
            if self.best_rate is None or rate > self.best_rate:
                return True
            if rate < self.best_rate:
                return False
            # rate tied: FAD (lower = better) breaks the tie
            return (fad is not None and self.best_fad is not None
                    and fad < self.best_fad - self.config.fad_tie_delta)
        if fad is not None:  # no detector: FAD-only mode
            return (self.best_fad is None
                    or fad < self.best_fad - self.config.fad_tie_delta)
        return False

    def observe(self, rate: Optional[float], fad: Optional[float],
                chunk: int = 0, step: int = 0) -> Optional[dict]:
        """Feed one periodic eval; returns an event when the judgement
        changed (new best / stop), else None. Evals with neither signal
        (no detector, FAD off) are ignored entirely."""
        if self.stopped or (rate is None and fad is None):
            return None
        self.evals += 1
        if self._improved(rate, fad):
            self.best_rate = rate if rate is not None else self.best_rate
            self.best_fad = fad if fad is not None else self.best_fad
            self.best_chunk, self.best_step = chunk, step
            self.since_best = 0
            return {"kind": "quality_best", "chunk": chunk, "step": step,
                    "rate": rate, "fad": fad}
        self.since_best += 1
        if (self.evals >= self.config.warmup_evals
                and self.since_best >= self.config.patience):
            self.stopped = True
            return {"kind": "early_stop", "chunk": chunk, "step": step,
                    "rate": rate, "fad": fad,
                    "since_best": self.since_best,
                    "best_chunk": self.best_chunk,
                    "best_step": self.best_step,
                    "best_rate": self.best_rate, "best_fad": self.best_fad}
        return None


def replay_eval_log(path: str, policy: QualityEarlyStop,
                    upto_chunk: Optional[int] = None) -> List[dict]:
    """Re-derive policy state from an endurance JSONL log by feeding its
    periodic eval records (kind == "eval") through `policy` in order.

    Used by (a) the endurance script's resume path — best-so-far and
    evals-since-best survive kill -9 exactly because they are a pure
    function of the log prefix — and (b) examples/early_stop_replay.py,
    which answers "where WOULD this policy have stopped run N" offline.

    `upto_chunk` bounds the replay to records at or before the restored
    checkpoint's chunk (later records belong to a lost tail about to be
    re-trained — same contract as the controller's event replay).
    Torn trailing lines from a kill -9 mid-write are skipped.
    """
    events: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn last line (kill -9 mid-write)
                if rec.get("kind") != "eval":
                    continue
                if upto_chunk is not None and rec.get("chunk", 0) > upto_chunk:
                    continue
                ev = policy.observe(rec.get("rate"), rec.get("fad"),
                                    chunk=rec.get("chunk", 0),
                                    step=rec.get("step", 0))
                if ev is not None:
                    events.append(ev)
    except OSError:
        pass
    return events
