"""Traffic: the benchmark's frozen copy of the YCSB generator, and the
stream of calls a closed loop of client lanes draws from it.

A mix is a data file (``bench/traffic/<name>.json``) read by
:func:`Stream.from_mix`; nothing here knows a mix by name.  The keys and
the write flags are drawn once, at set-up, from the seed: a trace pool
of ``pool_requests`` requests in YCSB's scrambled zipfian, interleaved
round-robin over the lanes into rows.  Each call takes the next
``rows_per_call`` rows; a window that serves more than the pool holds
replays it cyclically from a row chosen by the seed (a YCSB stream is
stationary, so the replay is the same traffic).

Before the run, YCSB loads the records.  Here the load phase SETs
``load_keys`` distinct keys of the trace pool, in the order they first
appear in it (the popular ones first), so the run starts on a pool that
is full, or holds every key the run asks for, as a deployed cache does.
"""

from __future__ import annotations

import numpy as np


def zipf_probs(n, theta):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-theta)
    return p / p.sum()


def zipfian(n_requests, n_keys, theta, seed):
    """YCSB's scrambled zipfian: key ranks drawn by the zipf law, then
    mapped through a random permutation of the key space; keys >= 1."""
    rng = np.random.default_rng(seed)
    ranks = rng.choice(n_keys, size=n_requests, p=zipf_probs(n_keys, theta))
    ranks = rng.permutation(n_keys)[ranks]
    return (ranks + 1).astype(np.uint32)


# The share of updates of YCSB's core workloads A, B and C.
UPDATE_SHARE = {"A": 0.5, "B": 0.05, "C": 0.0}


def ycsb(workload, n_requests, n_keys, theta, seed):
    """(keys u32[N], is_write bool[N]) of a YCSB core workload."""
    w = workload.upper()
    if w not in UPDATE_SHARE:
        raise ValueError(f"unknown YCSB workload {workload!r}")
    keys = zipfian(n_requests, n_keys, theta, seed)
    is_write = np.random.default_rng(seed + 17).random(n_requests) \
        < UPDATE_SHARE[w]
    return keys, is_write


def interleave(keys, lanes, is_write):
    """A flat stream as [T, lanes] rows: lane c takes requests c, c +
    lanes, ... (each client its round-robin share of the stream)."""
    T = len(keys) // lanes
    return (keys[:T * lanes].reshape(T, lanes),
            is_write[:T * lanes].reshape(T, lanes))


class Stream:
    """The calls of a closed loop: each :meth:`next` gives the next
    ``rows_per_call`` rows of the trace pool (keys, is_write), wrapping
    to its first row at its end."""

    def __init__(self, keys, is_write, rows_per_call, start_row):
        self.keys, self.is_write = keys, is_write
        self.rows = int(rows_per_call)
        self.start = int(start_row) % keys.shape[0]
        self.at = self.start
        self.served = 0

    @classmethod
    def from_mix(cls, mix, lanes, seed):
        if mix["generator"] != "ycsb":
            raise ValueError(f"unknown generator {mix['generator']!r}")
        keys, wr = ycsb(mix["workload"], int(mix["pool_requests"]),
                        int(mix["n_keys"]), float(mix["theta"]), seed)
        k2, w2 = interleave(keys, lanes, wr)
        start = np.random.default_rng(seed + 29).integers(k2.shape[0])
        return cls(k2, w2, mix["rows_per_call"], start)

    def load_calls(self, n_keys, rows, align):
        """The load phase's calls: (keys, is_write) of [rows, lanes] each,
        SETs of the pool's first ``n_keys`` distinct keys, the last call
        padded with empty requests to a multiple of ``align`` rows."""
        flat = self.keys.reshape(-1)
        uniq, first = np.unique(flat, return_index=True)
        keys = uniq[np.argsort(first)][:int(n_keys)]
        lanes = self.keys.shape[1]
        n_rows = -(-len(keys) // lanes)
        n_rows = -(-n_rows // align) * align
        grid = np.zeros(n_rows * lanes, np.uint32)
        grid[:len(keys)] = keys
        grid = grid.reshape(n_rows, lanes)
        return [(grid[r:r + rows], np.ones_like(grid[r:r + rows], bool))
                for r in range(0, n_rows, rows)]

    def next(self):
        T = self.keys.shape[0]
        idx = (self.at + np.arange(self.rows)) % T
        self.at = (self.at + self.rows) % T
        self.served += self.rows
        return self.keys[idx], self.is_write[idx]

    @property
    def replayed(self):
        """Whether the calls so far have served more rows than the pool
        holds."""
        return self.served > self.keys.shape[0]
