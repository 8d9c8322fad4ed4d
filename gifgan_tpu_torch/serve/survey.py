"""Human-survey hosting (gifgan_tpu/serve/survey.py): serve exported sample
sets + collect responses. Host only: stdlib HTTP and JSON, no tensor.

Replaces the reference's Firebase stack (firebase/firebase.json hosting of
three 250-GIF sample sets + an auth-gated realtime DB for responses,
SURVEY.md §2.7) with a self-contained stdlib server:

  GET  /                -> survey UI (embedded). When the sample dir holds a
                           pairs.json (eval/survey.py make_pair_manifest),
                           the randomized A/B pair-comparison UI — the
                           reference's actual MTurk methodology ("Choose
                           which video is more realistic",
                           data_collection/mturk/randomize_csv.py:44-53) —
                           otherwise the absolute 1-5 rating UI.
  GET  /manifest.json   -> the eval/survey.py export manifest
  GET  /pairs.json      -> the randomized pair manifest (A/B mode)
  GET  /<variant>_samples/<n>.gif
  POST /response        -> JSON appended to responses.jsonl (atomic line
                           appends): {gif, variant, rating, worker} in
                           rating mode, {pair, choice: "A"|"B", worker} in
                           A/B mode. With a worker allowlist configured,
                           responses from unlisted workers are rejected 403
                           (the reference gated HITs per-worker via MTurk
                           qualifications on its whitelisted batches,
                           data_collection/mturk/2017_03_19_whitelist_rnn).
  GET  /results         -> aggregated mean rating per variant, plus
                           un-swapped preference win-rates / per-worker
                           stats / best pairs in A/B mode (the reference's
                           analyze_results.sql queries)
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from typing import Dict, Optional

from gifgan_tpu_torch.eval.survey import aggregate_pair_responses
from gifgan_tpu_torch.serve.http_common import (MAX_FORM_BODY, body_length,
                                                make_server)


_SURVEY_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sample survey</title>
<style>
 body{font-family:system-ui,sans-serif;background:#111;color:#eee;
      text-align:center;padding:40px}
 img{width:256px;height:256px;image-rendering:pixelated;border-radius:8px}
 button{margin:8px;padding:10px 20px;font-size:16px;border:0;
        border-radius:8px;cursor:pointer;background:#2d6cdf;color:#fff}
 #done{color:#8f8}
</style></head><body>
<h2>How realistic is this animation?</h2>
<div><img id="gif" alt="sample"></div>
<div id="buttons"></div>
<div id="progress"></div><div id="done"></div>
<script>
let items = [], idx = 0;
const worker = "w_" + Math.random().toString(36).slice(2, 10);
fetch("manifest.json").then(r => r.json()).then(m => {
  for (const [variant, files] of Object.entries(m.variants))
    for (const f of files) items.push({variant, f});
  for (let i = items.length - 1; i > 0; i--) {
    const j = Math.floor(Math.random() * (i + 1));
    [items[i], items[j]] = [items[j], items[i]];
  }
  show();
});
const labels = ["1 (fake)", "2", "3", "4", "5 (real)"];
document.getElementById("buttons").innerHTML =
  labels.map((l, i) => `<button onclick="rate(${i + 1})">${l}</button>`).join("");
function show() {
  if (idx >= items.length) {
    document.getElementById("done").textContent = "All done — thank you!";
    return;
  }
  document.getElementById("gif").src = items[idx].f;
  document.getElementById("progress").textContent =
    `${idx + 1} / ${items.length}`;
}
function rate(r) {
  const it = items[idx];
  fetch("response", {method: "POST", headers: {"Content-Type":
    "application/json"}, body: JSON.stringify(
    {gif: it.f, variant: it.variant, rating: r, worker})});
  idx++; show();
}
</script></body></html>
"""


_AB_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>A/B survey</title>
<style>
 body{font-family:system-ui,sans-serif;background:#111;color:#eee;
      text-align:center;padding:40px}
 img{width:256px;height:256px;image-rendering:pixelated;border-radius:8px;
     margin:0 12px}
 .opt{display:inline-block}
 button{margin:8px;padding:10px 28px;font-size:16px;border:0;
        border-radius:8px;cursor:pointer;background:#2d6cdf;color:#fff}
 #done{color:#8f8}
</style></head><body>
<h2>Choose which video is more realistic</h2>
<div>
 <div class="opt"><img id="gifA" alt="A"><br>
  <button onclick="choose('A')">A is more realistic</button></div>
 <div class="opt"><img id="gifB" alt="B"><br>
  <button onclick="choose('B')">B is more realistic</button></div>
</div>
<div id="progress"></div><div id="done"></div>
<script>
let pairs = [], idx = 0;
const worker = new URLSearchParams(location.search).get("worker") ||
  "w_" + Math.random().toString(36).slice(2, 10);
fetch("pairs.json").then(r => r.json()).then(m => {
  pairs = m.pairs.slice();
  for (let i = pairs.length - 1; i > 0; i--) {
    const j = Math.floor(Math.random() * (i + 1));
    [pairs[i], pairs[j]] = [pairs[j], pairs[i]];
  }
  show();
});
function show() {
  if (idx >= pairs.length) {
    document.getElementById("done").textContent = "All done — thank you!";
    return;
  }
  document.getElementById("gifA").src = pairs[idx].shown_a;
  document.getElementById("gifB").src = pairs[idx].shown_b;
  document.getElementById("progress").textContent =
    `${idx + 1} / ${pairs.length}`;
}
function choose(c) {
  fetch("response", {method: "POST", headers: {"Content-Type":
    "application/json"}, body: JSON.stringify(
    {pair: pairs[idx].id, choice: c, worker})});
  idx++; show();
}
</script></body></html>
"""


class SurveyServer:
    def __init__(self, sample_dir: str,
                 responses_path: Optional[str] = None,
                 allowed_workers=None):
        self.sample_dir = sample_dir
        self.responses_path = responses_path or os.path.join(
            sample_dir, "responses.jsonl")
        self.allowed_workers = (set(allowed_workers)
                                if allowed_workers is not None else None)
        self.pairs = None
        try:
            with open(os.path.join(sample_dir, "pairs.json")) as f:
                self.pairs = json.load(f)
        except (OSError, ValueError):
            pass
        self._pair_ids = ({p["id"] for p in self.pairs["pairs"]}
                          if self.pairs else set())
        self._lock = threading.Lock()

    def record(self, response: Dict) -> None:
        if self.allowed_workers is not None and \
                response.get("worker") not in self.allowed_workers:
            raise PermissionError("worker not on the allowlist")
        if "pair" in response:
            if self.pairs is None:
                raise ValueError("no pairs.json — A/B responses not enabled")
            if response["pair"] not in self._pair_ids:
                raise ValueError(f"unknown pair {response['pair']!r}")
            if response.get("choice") not in ("A", "B"):
                raise ValueError('choice must be "A" or "B"')
        else:
            for field in ("gif", "variant", "rating"):
                if field not in response:
                    raise ValueError(f"missing field {field}")
            response["rating"] = int(response["rating"])
            if not 1 <= response["rating"] <= 5:
                raise ValueError("rating must be 1..5")
        with self._lock:
            with open(self.responses_path, "a") as f:
                f.write(json.dumps(response) + "\n")

    def _read_responses(self):
        out = []
        if os.path.exists(self.responses_path):
            with open(self.responses_path) as f:
                for line in f:
                    if line.strip():
                        try:
                            out.append(json.loads(line))
                        except ValueError:
                            continue  # torn tail from a crash mid-append
        return out

    def results(self) -> Dict:
        responses = self._read_responses()
        agg = defaultdict(list)
        for r in responses:
            if "rating" in r:
                agg[r["variant"]].append(r["rating"])
        out = {
            "variants": {
                v: {"n": len(rs), "mean_rating": sum(rs) / len(rs)}
                for v, rs in sorted(agg.items())
            }
        }
        if self.pairs is not None:
            out["ab"] = aggregate_pair_responses(
                self.pairs, (r for r in responses if "pair" in r))
        return out


def serve(survey: SurveyServer, host: str = "127.0.0.1", port: int = 8082,
          background: bool = False,
          tls_cert: str = None, tls_key: str = None):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                page = _AB_PAGE if survey.pairs is not None else _SURVEY_PAGE
                return self._send(page.encode(), "text/html")
            if path == "/results":
                return self._send(json.dumps(survey.results()).encode(),
                                  "application/json")
            rel = path.lstrip("/")
            base = os.path.abspath(survey.sample_dir)
            full = os.path.abspath(os.path.join(base, rel))
            if full != base and not full.startswith(base + os.sep):
                return self._send(b"{}", "application/json", 403)
            if rel in ("manifest.json", "pairs.json") or rel.endswith(".gif"):
                try:
                    with open(full, "rb") as f:
                        body = f.read()
                except OSError:
                    return self._send(b"{}", "application/json", 404)
                ctype = ("application/json" if rel.endswith(".json")
                         else "image/gif")
                return self._send(body, ctype)
            self._send(b"{}", "application/json", 404)

        def do_POST(self):
            if self.path.split("?")[0] != "/response":
                return self._send(b"{}", "application/json", 404)
            n = body_length(self, MAX_FORM_BODY)
            if n is None:
                return
            try:
                survey.record(json.loads(self.rfile.read(n)))
                self._send(b'{"response": "success"}', "application/json")
            except PermissionError as e:
                self._send(json.dumps(
                    {"response": "error", "msg": str(e)}).encode(),
                    "application/json", 403)
            except Exception as e:
                self._send(json.dumps(
                    {"response": "error", "msg": str(e)}).encode(),
                    "application/json", 400)

    return make_server(host, port, Handler, background=background,
                       tls_cert=tls_cert, tls_key=tls_key)
