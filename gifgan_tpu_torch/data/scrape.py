"""Keyword-driven GIF-search scraper: the port's copy of
gifgan_tpu/data/scrape.py (host code; kept here so the port imports nothing
of the JAX package). The reference is data_collection/giphy_scrape.py.

Behavioral parity with the reference scraper, restructured so it can be
tested offline:

  - keyword file with a "# keywords not tried yet" marker — only keywords
    after the marker are scraped (giphy_scrape.py:119-133)
  - media-id extraction from mp4 URLs in the search-API JSON
    (regex over "mp4":"...giphy.mp4", media/<id>/ — :38-44)
  - global media-id dedup set, pre-seeded by scanning the output tree, with
    a duplicate-on-disk hard error (:135-147)
  - N worker threads per keyword, each covering its own offset range in
    pages of 100, with a consecutive-failure cutoff of 20 (:28-69)
  - per-keyword / total new-download counters

The HTTP layer is injected (`fetch_fn(url) -> bytes`) so the scrape logic is
unit-testable offline and the production fetcher is swappable.
"""

from __future__ import annotations

import os
import re
import threading
from urllib.parse import quote_plus
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

SEARCH_URL = "https://api.giphy.com/v1/gifs/search?q={query}&api_key={key}&limit=100&offset={offset}"
MP4_RE = re.compile(r'"mp4":"([^"]+giphy\.mp4)"')
MEDIA_ID_RE = re.compile(r"media/([^/]+)/")
NOT_TRIED_MARKER = "# keywords not tried yet"


def parse_keywords(text: str) -> List[str]:
    """Keywords AFTER the not-tried marker, skipping blanks."""
    out, begin = [], False
    for line in text.splitlines():
        k = line.rstrip("\n")
        if k == NOT_TRIED_MARKER:
            begin = True
        elif begin and k:
            out.append(k)
    return out


def extract_mp4_urls(payload: str) -> List[str]:
    return [u.replace("\\", "") for u in MP4_RE.findall(payload)]


def media_id(url: str) -> Optional[str]:
    m = MEDIA_ID_RE.search(url)
    return m.group(1) if m else None


def scan_existing(root: str) -> Set[str]:
    """Seed the dedup set from already-downloaded files; duplicate ids on
    disk are a hard error (giphy_scrape.py:143-146)."""
    seen: Set[str] = set()
    if not os.path.isdir(root):
        return seen
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".mp4"):
                vid = f[:-4]
                if vid in seen:
                    raise RuntimeError(f"duplicate video id on disk: {vid}")
                seen.add(vid)
    return seen


@dataclass
class ScrapeStats:
    new_total: int = 0
    per_keyword: Dict[str, int] = field(default_factory=dict)
    errors: int = 0


class Scraper:
    def __init__(self, out_dir: str,
                 fetch_fn: Callable[[str], bytes],
                 api_key: str = "",
                 num_threads: int = 8,
                 items_per_thread: int = 200,
                 max_consecutive_failures: int = 20):
        self.out_dir = out_dir
        self.fetch_fn = fetch_fn
        self.api_key = api_key
        self.num_threads = num_threads
        self.items_per_thread = items_per_thread
        self.max_consecutive_failures = max_consecutive_failures
        self._lock = threading.RLock()
        self._seen = scan_existing(out_dir)
        self.stats = ScrapeStats()

    def _claim(self, vid: str, keyword: str) -> bool:
        with self._lock:
            if vid in self._seen:
                return False
            self._seen.add(vid)
            self.stats.new_total += 1
            self.stats.per_keyword[keyword] = (
                self.stats.per_keyword.get(keyword, 0) + 1)
            return True

    def _unclaim(self, vid: str, keyword: str) -> None:
        """Roll back a claim whose download failed so a retry (or another
        worker) can fetch it and the stats stay truthful."""
        with self._lock:
            self._seen.discard(vid)
            self.stats.new_total -= 1
            self.stats.per_keyword[keyword] = (
                self.stats.per_keyword.get(keyword, 1) - 1)

    def _worker(self, thread_id: int, keyword: str, kw_dir: str):
        pages = self.items_per_thread // 100
        i = 0
        failures = 0
        while i < pages and failures < self.max_consecutive_failures:
            offset = thread_id * self.items_per_thread + 100 * i
            try:
                url = SEARCH_URL.format(query=quote_plus(keyword),
                                        key=self.api_key, offset=offset)
                payload = self.fetch_fn(url).decode("utf-8", "replace")
                for mp4_url in extract_mp4_urls(payload):
                    vid = media_id(mp4_url)
                    if vid is None or not self._claim(vid, keyword):
                        continue
                    try:
                        data = self.fetch_fn(mp4_url)
                        with open(os.path.join(kw_dir, vid + ".mp4"),
                                  "wb") as f:
                            f.write(data)
                    except Exception:
                        self._unclaim(vid, keyword)
                        raise
                i += 1
                failures = 0
            except Exception:
                failures += 1
                with self._lock:
                    self.stats.errors += 1

    def scrape(self, keywords: List[str]) -> ScrapeStats:
        for keyword in keywords:
            # slug-sanitize: a keyword containing '/' or '..' must not escape
            # out_dir (and must stay inside scan_existing's dedup walk)
            slug = re.sub(r"[^A-Za-z0-9_-]", "_", keyword.replace(" ", "_"))
            kw_dir = os.path.join(self.out_dir, slug.strip("_") or "unknown")
            os.makedirs(kw_dir, exist_ok=True)
            threads = [
                threading.Thread(target=self._worker, args=(t, keyword, kw_dir))
                for t in range(self.num_threads)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return self.stats


def default_fetch(url: str, timeout: float = 30.0) -> bytes:
    """urllib fetcher for networked environments."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as r:
        return r.read()
