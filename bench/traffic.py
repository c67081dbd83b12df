"""The one traffic generator: a cell's workload file and the seed give
its requests.

Every seed gets the same multiset of sizes and gaps, in another order.
Lengths are the stratified quantiles of the stated distribution (point
``(i + 0.5) / n`` of ``n``), clipped to the stated range; the seed only
permutes them and draws the token ids. So two seeds differ in which
request is long and when, never in how much work a run holds.

Workload keys read here:

* ``loop``: ``"open"`` (requests due on a schedule, whatever the engine
  does) or ``"closed"`` (``clients`` callers, each sending its next
  request when its previous one has finished).
* ``prompt`` / ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}`` (inclusive).
* open loop, ``arrival``: ``{"kind": "poisson", "rate"}`` (requests a
  second: ``round(rate * seconds)`` requests fall due inside a window of
  ``seconds``, after stratified exponential gaps, permuted, that sum to
  the window) or ``{"kind": "burst", "size", "rate"}`` (``size``
  requests due together every ``size / rate`` seconds, from 0, while the
  burst's whole period lies inside the window, so the last burst has
  its period to be served in; ``rate`` is the mean of requests a second;
  every burst holds the same ``size`` stratified lengths, each in its own
  seeded order, so no burst is heavier than another).
* closed loop, ``clients``: the sizes cycle through a stratified set of
  ``clients`` entries, each cycle in its own seeded order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

#: the seed as numpy takes it (any whole number, negative ones folded)
SEED_MOD = 2 ** 63


@dataclass(frozen=True)
class Entry:
    """One request of a run: its index (the request id), when it falls
    due (seconds after the window opens; None in a closed loop, where a
    client's completion decides), and its sizes."""
    index: int
    due: float | None
    prompt_len: int
    max_new: int


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, *salt])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified lengths of ``dist``, sorted, as ints."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "lognormal":
        nd = NormalDist()
        z = np.array([nd.inv_cdf(float(x)) for x in u])
        v = np.rint(np.exp(math.log(dist["median"]) + dist["sigma"] * z))
    elif kind == "uniform":
        v = np.floor(lo + u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(v, lo, hi).astype(np.int64)


def _gaps(n: int, mean: float) -> np.ndarray:
    """Stratified exponential gaps of the given mean, sorted."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) * mean


def open_schedule(wl: dict, seed: int, seconds: float) -> List[Entry]:
    """The requests of an open-loop cell that fall due inside a window of
    ``seconds``, the first at 0."""
    arr = wl["arrival"]
    rate = float(arr["rate"])
    rng = _rng(seed, 1)
    if arr["kind"] == "poisson":
        size, groups = 1, max(1, round(rate * seconds))
        gaps = rng.permutation(_gaps(groups, seconds / groups))
        starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        n = groups
        plens = rng.permutation(quantiles(wl["prompt"], n))
        news = rng.permutation(quantiles(wl["output"], n))
    elif arr["kind"] == "burst":
        size = int(arr["size"])
        period = size / rate
        groups = max(1, int(math.floor(seconds / period + 1e-9)))
        starts = period * np.arange(groups)
        n = groups * size
        p, o = quantiles(wl["prompt"], size), quantiles(wl["output"], size)
        plens = np.concatenate([rng.permutation(p) for _ in range(groups)])
        news = np.concatenate([rng.permutation(o) for _ in range(groups)])
    else:
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    return [Entry(i, float(starts[i // size]), int(plens[i]), int(news[i]))
            for i in range(n)]


class ClosedPool:
    """The request sequence of a closed-loop cell: request ``k`` takes
    the sizes at place ``k % clients`` of its cycle's seeded order."""

    def __init__(self, wl: dict, seed: int):
        self.seed = seed
        self.period = int(wl["clients"])
        self._plens = quantiles(wl["prompt"], self.period)
        self._news = quantiles(wl["output"], self.period)
        self._orders: dict = {}

    def entry(self, k: int) -> Entry:
        cycle, place = divmod(k, self.period)
        order = self._orders.get(cycle)
        if order is None:
            rng = _rng(self.seed, 2, cycle)
            order = self._orders[cycle] = (rng.permutation(self.period),
                                           rng.permutation(self.period))
        return Entry(k, None, int(self._plens[order[0][place]]),
                     int(self._news[order[1][place]]))


def prompt_tokens(seed: int, index: int, length: int,
                  vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: ``length`` token ids uniform over the
    vocabulary, from the seed, (1, length) int32."""
    rng = _rng(seed, 3, index)
    return rng.integers(0, vocab, size=(1, length), dtype=np.int32)


def longest_request(wl: dict) -> int:
    """Tokens the longest request of the cell can hold (prompt and
    output): the engine's cache length."""
    return int(wl["prompt"]["max"]) + int(wl["output"]["max"])
