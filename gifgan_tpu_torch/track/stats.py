"""Preprocessing statistics: counters, histograms, live HTML dashboard, and
cross-shard merging.

Rebuild of the reference's Stats/observability layer (track_faces.py:115-172
counters+histograms, :734-996 dashboard, :1073-1074 params.txt) and the
multi-worker scale-out story (stat_combination.py:9-80: shard the input dir,
run N workers, merge the stats files by counter addition + histogram union).

This is the port's own copy of gifgan_tpu/track/stats.py (stdlib only):
stats.json, stats.txt and the dashboard have the same format, so either
package's combine_stats_files merges the other's output.

The dashboard is a self-contained HTML page (vanilla JS bar charts, 15 s
auto-refresh like the reference's :38) regenerated atomically during a run.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

COUNTER_NAMES = [
    "cnt_files_processed",
    "cnt_files_errored",
    "cnt_total_detections",
    "cnt_initial_tracks",
    "cnt_detections_kept",
    "cnt_detections_written",
    "cnt_final_tracks",
    "cnt_drop_because_low_frame_count",
    "cnt_drop_because_low_total_detections",
    "cnt_drop_because_expanded_bb_too_big",
    "cnt_drop_because_optical_flow_bb_too_big",
    "cnt_drop_because_no_feature_points",
    "cnt_drop_because_failed_optical_flow",
    "cnt_drop_because_no_rigid_transform",
    "cnt_drop_because_stabilized_bb_too_big",
    "cnt_truncate_because_optical_flow_bb_too_big",
    "cnt_truncate_because_no_feature_points",
    "cnt_truncate_because_failed_optical_flow",
    "cnt_truncate_because_no_rigid_transform",
    "cnt_truncate_because_stabilized_bb_too_big",
]

HIST_NAMES = [
    "hst_time_per_gif",
    "hst_jaccard_raw",
    "hst_jaccard_used",
    "hst_skip_raw",
    "hst_skip_used",
    "hst_num_feature_points",
    "hst_track_len_raw",
    "hst_track_len_final",
    "hst_frame_height_raw",
    "hst_frame_width_raw",
    "hst_faces_per_gif",
]

JACCARD_BIN = 0.05
TIME_BIN = 0.5


def _inc(hist: Dict, key, amount: int = 1):
    hist[key] = hist.get(key, 0) + amount


@dataclass
class TrackStats:
    counters: Dict[str, int] = field(
        default_factory=lambda: {c: 0 for c in COUNTER_NAMES})
    histograms: Dict[str, Dict] = field(
        default_factory=lambda: {h: {} for h in HIST_NAMES})
    total_files: int = 0
    start_time: float = field(default_factory=time.time)

    # attribute-style counter access so pipeline code reads naturally
    def __getattr__(self, name):
        if name.startswith("cnt_"):
            return self.__dict__["counters"].get(name, 0)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("cnt_"):
            self.counters[name] = value
        else:
            object.__setattr__(self, name, value)

    # observation helpers used by the pipeline stages
    def observe_jaccard_raw(self, j: float, skip: int):
        _inc(self.histograms["hst_jaccard_raw"],
             round(round(j / JACCARD_BIN) * JACCARD_BIN, 4))
        _inc(self.histograms["hst_skip_raw"], skip)

    def observe_jaccard_used(self, j: float, skip: int):
        _inc(self.histograms["hst_jaccard_used"],
             round(round(j / JACCARD_BIN) * JACCARD_BIN, 4))
        _inc(self.histograms["hst_skip_used"], skip)

    def observe_feature_points(self, n: int):
        _inc(self.histograms["hst_num_feature_points"], n)

    def observe_file_time(self, seconds: float):
        _inc(self.histograms["hst_time_per_gif"],
             round(round(seconds / TIME_BIN) * TIME_BIN, 2))

    def observe_track(self, length: int, heights=None, widths=None):
        _inc(self.histograms["hst_track_len_raw"], length)
        for h in heights or []:
            _inc(self.histograms["hst_frame_height_raw"], h)
        for w in widths or []:
            _inc(self.histograms["hst_frame_width_raw"], w)

    def observe_final(self, num_tracks: int, lengths=None):
        self.cnt_final_tracks += num_tracks
        _inc(self.histograms["hst_faces_per_gif"], num_tracks)
        for ln in lengths or []:
            _inc(self.histograms["hst_track_len_final"], ln)

    # serialization / merging ------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "counters": dict(self.counters),
            "histograms": {k: {str(kk): vv for kk, vv in v.items()}
                           for k, v in self.histograms.items()},
            "total_files": self.total_files,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TrackStats":
        s = cls()
        s.counters.update(d.get("counters", {}))
        for name, hist in d.get("histograms", {}).items():
            s.histograms.setdefault(name, {})
            for k, v in hist.items():
                try:
                    key = float(k) if "." in k else int(k)
                except ValueError:
                    key = k
                s.histograms[name][key] = v
        s.total_files = d.get("total_files", 0)
        return s

    def update(self, other: "TrackStats") -> None:
        """In-place counter addition + histogram union — the per-worker
        stats accumulation path (pipeline.run_directory workers>1)."""
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for name, hist in other.histograms.items():
            self.histograms.setdefault(name, {})
            for k, v in hist.items():
                _inc(self.histograms[name], k, v)
        self.total_files += other.total_files

    def merge(self, other: "TrackStats") -> "TrackStats":
        """Counter addition + histogram union (stat_combination.py:16-65)."""
        out = TrackStats.from_dict(self.to_dict())
        out.update(other)
        return out

    # rendering --------------------------------------------------------------
    def render_text(self) -> str:
        lines = ["# gifgan_tpu track stats", ""]
        for k in sorted(self.counters):
            lines.append(f"{k}: {self.counters[k]}")
        lines.append("")
        for name in sorted(self.histograms):
            hist = self.histograms[name]
            items = " ".join(f"{k}:{hist[k]}" for k in sorted(hist))
            lines.append(f"{name}: {items}")
        return "\n".join(lines) + "\n"

    def render_html(self, params: Optional[Dict] = None,
                    refresh_seconds: int = 15) -> str:
        done = self.cnt_files_processed + self.cnt_files_errored
        pct = 100.0 * done / self.total_files if self.total_files else 0.0
        elapsed = time.time() - self.start_time
        eta = (elapsed / done * (self.total_files - done)) if done else 0.0
        payload = json.dumps(self.to_dict())
        return _DASHBOARD_TEMPLATE % {
            "refresh": refresh_seconds,
            "pct": f"{pct:.1f}",
            "done": done,
            "total": self.total_files,
            "eta_min": f"{eta / 60:.1f}",
            "errors": self.cnt_files_errored,
            "payload": payload,
            "params": json.dumps(params or {}, indent=2),
        }

    def write(self, out_dir: str, params: Optional[Dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        for name, content in (("stats.txt", self.render_text()),
                              ("stats.json", json.dumps(self.to_dict())),
                              ("stats.html", self.render_html(params))):
            tmp = os.path.join(out_dir, name + ".tmp")
            with open(tmp, "w") as f:
                f.write(content)
            os.replace(tmp, os.path.join(out_dir, name))


def combine_stats_files(paths) -> TrackStats:
    """Merge stats.json files from sharded runs (stat_combination.py:70-80)."""
    out = TrackStats()
    for p in paths:
        with open(p) as f:
            out = out.merge(TrackStats.from_dict(json.load(f)))
    return out


_DASHBOARD_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="%(refresh)d">
<title>gifgan_tpu preprocessing</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 24px; background: #fafafa; }
 .card { background: #fff; border: 1px solid #ddd; border-radius: 8px;
         padding: 12px 16px; margin: 10px; display: inline-block;
         vertical-align: top; }
 .big { font-size: 28px; font-weight: 600; }
 h1 { font-size: 20px; } h2 { font-size: 14px; color: #555; margin: 4px 0; }
 .bar { fill: #4878cf; } text { font-size: 9px; fill: #444; }
 pre { font-size: 11px; color: #666; }
</style></head><body>
<h1>gifgan_tpu preprocessing dashboard</h1>
<div class="card"><h2>progress</h2><div class="big">%(pct)s%%</div>
 <div>%(done)d / %(total)d files &middot; ETA %(eta_min)s min &middot;
 errors: %(errors)d</div></div>
<div id="charts"></div>
<div class="card"><h2>params</h2><pre>%(params)s</pre></div>
<div class="card"><h2>counters</h2><div id="counters"></div></div>
<script>
const data = %(payload)s;
const charts = document.getElementById('charts');
for (const [name, hist] of Object.entries(data.histograms)) {
  // keep ORIGINAL string keys for lookup (Number("1.0") -> 1 would miss
  // the "1.0" property); sort numerically
  const entries = Object.entries(hist)
    .sort((a, b) => Number(a[0]) - Number(b[0]));
  if (!entries.length) continue;
  const w = 260, h = 120, max = Math.max(...entries.map(e => e[1]));
  const bw = Math.max(2, Math.floor(w / entries.length) - 1);
  let bars = '';
  entries.forEach(([k, v], i) => {
    const bh = Math.round((v / max) * (h - 20));
    bars += `<rect class="bar" x="${i*(bw+1)}" y="${h-bh-12}" width="${bw}"
             height="${bh}"><title>${k}: ${v}</title></rect>`;
    if (i %% Math.ceil(entries.length/8) === 0)
      bars += `<text x="${i*(bw+1)}" y="${h-2}">${Number(k)}</text>`;
  });
  charts.insertAdjacentHTML('beforeend',
    `<div class="card"><h2>${name}</h2>
     <svg width="${w}" height="${h}">${bars}</svg></div>`);
}
const counters = document.getElementById('counters');
counters.innerHTML = Object.entries(data.counters)
  .map(([k,v]) => `${k}: <b>${v}</b>`).join('<br>');
</script></body></html>
"""
