"""The one traffic generator and its two drivers.

A traffic mix is a JSON file under ``benchmark/traffic/``; this module
reads its parameters and nothing else decides the load:

  ``loop``        "closed" (``clients`` callers, each sending its next
                  request once the last one's audio is back) or "open"
                  (arrivals at ``rate_per_s``, whatever the system does);
  ``words``       [lo, hi] words of English text a request (uniform);
  ``tokens_per_word``, ``cap_jitter``  a request's semantic-token cap is
                  tokens_per_word · words · U(cap_jitter);
  ``first_share`` [lo, hi]: a closed-loop client's first cap is scaled by
                  U(first_share), so the window opens on slots at mixed ages;
  ``ramp_s``      seconds of traffic before the window opens;
  ``drain_s``     (open loop) how long requests due in the window may take
                  to finish after it closes.

The seed fixes the order, the texts, the voice properties and each
request's own seed; the multiset of sizes (words, caps, first shares,
arrival gaps) is the same for every seed, drawn at stratified quantiles,
so two seeds differ in order and content and not in the amount of work.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

# the serving soak's vocabulary and properties (property tokens exist for
# each value)
WORDS = ("the quick brown fox jumps over the lazy dog while rain keeps "
         "falling on the quiet field and nobody notices the time pass "
         "until morning light returns softly").split()
EMOTIONS = ("NEUTRAL", "HAPPY", "SAD", "ANGRY", "SURPRISED")
SPEEDS = ("slow", "medium", "fast")
AGES = ("teenager", "youth-adult", "middle-aged", "elderly")
GENDERS = ("female", "male")
PITCHES = ("low_pitch", "medium_pitch", "high_pitch")


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), salt])


def _stratified(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """n values at the mid-quantiles of U(lo, hi), in the seed's order."""
    return lo + (hi - lo) * rng.permutation((np.arange(n) + 0.5) / n)


def requests(mix: dict, seed: int, count: int) -> List[dict]:
    """``count`` requests: text, words, cap, the five voice properties and
    the request's sampling seed."""
    rng = _rng(seed, 1)
    lo, hi = mix["words"]
    # the (words, cap factor) pairs are the same for every seed (paired by
    # a fixed draw); the seed deals them out in its own order
    words = np.resize(np.arange(lo, hi + 1), count)
    jitter = _stratified(_rng(0, 1), count, *mix["cap_jitter"])
    order = rng.permutation(count)
    words, jitter = words[order], jitter[order]
    out = []
    for i in range(count):
        n = int(words[i])
        out.append({
            "id": i, "n_words": n,
            "text": " ".join(rng.choice(WORDS, n)),
            "max_tokens": max(1, int(round(mix["tokens_per_word"] * n
                                           * jitter[i]))),
            "age": str(rng.choice(AGES)), "gender": str(rng.choice(GENDERS)),
            "emotion": str(rng.choice(EMOTIONS)),
            "pitch": str(rng.choice(PITCHES)), "speed": str(rng.choice(SPEEDS)),
            "seed": int(rng.integers(0, 1 << 31)),
        })
    return out


def first_shares(mix: dict, seed: int, clients: int) -> np.ndarray:
    return _stratified(_rng(seed, 2), clients, *mix["first_share"])


def arrivals(mix: dict, seed: int, count: int) -> np.ndarray:
    """Open-loop due times (s from the traffic's start): Poisson gaps at
    ``rate_per_s`` at stratified quantiles, in the seed's order."""
    q = _stratified(_rng(seed, 3), count, 0.0, 1.0)
    return np.cumsum(-np.log1p(-q) / mix["rate_per_s"])


def request_count(mix: dict, seconds: float) -> int:
    """Enough requests for the ramp, the window and some slack."""
    span = mix["ramp_s"] + seconds
    if mix["loop"] == "closed":
        return mix["clients"] * int(np.ceil(span / mix["min_request_s"]) + 2)
    return int(np.ceil(mix["rate_per_s"] * span * 1.5)) + 16


def now() -> float:
    return time.time()


class ClosedLoop:
    """``clients`` threads; client c sends requests c, c + clients, … in
    turn. ``serve(req, rec)`` runs one request to its end and fills
    ``rec``; it raises ``Stopped`` when the run is being torn down."""

    def __init__(self, mix: dict, reqs: List[dict], shares, serve: Callable):
        self.mix, self.reqs, self.serve = mix, reqs, serve
        self.shares = shares
        self.records: List[dict] = []
        self.stop_event = threading.Event()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []

    def start(self):
        n = self.mix["clients"]
        for c in range(n):
            t = threading.Thread(target=self._client, args=(c, n),
                                 daemon=True, name=f"client-{c}")
            t.start()
            self._threads.append(t)

    def _client(self, c: int, n: int):
        for j, i in enumerate(range(c, len(self.reqs), n)):
            if self.stop_event.is_set():
                return
            req = dict(self.reqs[i])
            if j == 0:
                req["max_tokens"] = max(1, int(round(req["max_tokens"]
                                                     * self.shares[c])))
            rec = {"req": req, "t_submit": now()}
            try:
                self.serve(req, rec)
            except Stopped:
                return
            with self._lock:
                self.records.append(rec)

    def stop(self, cancel: Callable, timeout: float = 60.0):
        """No further requests; the ones in flight are cancelled
        (``cancel()``); waits up to ``timeout`` for the client threads."""
        self.stop_event.set()
        cancel()
        _join_all(self._threads, now() + timeout)


class OpenLoop:
    """One dispatcher thread starts each request at its due time on a
    thread of its own; ``serve(req, rec)`` as for ``ClosedLoop``."""

    def __init__(self, mix: dict, reqs: List[dict], due, serve: Callable):
        self.mix, self.reqs, self.due, self.serve = mix, reqs, due, serve
        self.records: List[dict] = []
        self.stop_event = threading.Event()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.t0: Optional[float] = None

    def start(self):
        self.t0 = now()
        d = threading.Thread(target=self._dispatch, daemon=True,
                             name="dispatch")
        d.start()
        self._dispatcher = d

    def _dispatch(self):
        for req, due in zip(self.reqs, self.due):
            at = self.t0 + float(due)
            while not self.stop_event.is_set() and now() < at:
                time.sleep(min(0.002, max(0.0, at - now())))
            if self.stop_event.is_set():
                return
            # recorded when due, so that a request still running when
            # the run stops is judged (it has no ``t_done``), not dropped
            rec = {"req": dict(req), "due": at, "failed": False}
            t = threading.Thread(target=self._one, args=(rec,), daemon=True)
            with self._lock:
                self.records.append(rec)
                self._threads.append(t)
            t.start()

    def _one(self, rec: dict):
        rec["t_submit"] = now()
        try:
            self.serve(rec["req"], rec)
        except Stopped:
            rec["failed"] = True

    def stop(self, cancel: Callable, drain_until: float):
        """No further arrivals; requests in flight may finish until
        ``drain_until``, the rest are cancelled and count as failed."""
        self.stop_event.set()
        self._dispatcher.join(10.0)
        with self._lock:
            threads = list(self._threads)
        _join_all(threads, drain_until)
        cancel()
        _join_all(threads, now() + 30.0)


def _join_all(threads, deadline: float):
    for t in threads:
        t.join(max(0.0, deadline - now()))


class Stopped(Exception):
    """The request was cancelled because the run is ending."""

