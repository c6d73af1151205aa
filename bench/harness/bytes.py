"""The bytes a cache step's requests need, at the columns' semantic
widths, and the table of peaks they are held against.

Each column counts at the width of the values it holds, whatever the
program stores it in: keys, hashes, history ids, timestamps and
frequencies are u32 (4 B), an object's size in blocks is a byte (it
stays below 255, the history mark), the extension metadata four f32
(16 B) and a value ``value_words`` u32 words.  Each input byte a step
needs is counted once and each output byte once:

* probe (``access_probe``): the 8 slots of every distinct bucket the
  step's requests name, key, hash, size, history id, insert time, last
  access and frequency (25 B a slot), each live request's key in and its
  hit flag and slot out;
* hit metadata (``hit_metadata_update``): at every distinct slot hit,
  its last access, frequency and extension in, last access and extension
  out; each FC flush a frequency in and out;
* eviction (``ranked_eviction``): each evicted object's sample of
  ``n_samples`` live slots (size, insert time, last access, frequency),
  the lane's expert cdf, and the victim's slot out;
* apply (``drop_scatter``): a SET hit's value and size, an insert's
  whole slot, an eviction's size, history id and expert bitmap;
* read (no kernel of its own): each GET hit's value, which the request
  returns.
"""

from __future__ import annotations

import numpy as np

from bench.reference.plan import buckets_of

# Semantic widths (bytes) of one slot's columns but its value.
WIDTH = dict(key=4, key_hash=4, size=1, ptr=4, insert_ts=4, last_ts=4,
             freq=4, ext=16)
PROBED = sum(WIDTH[c] for c in ("key", "key_hash", "size", "ptr",
                                "insert_ts", "last_ts", "freq"))
SAMPLED = sum(WIDTH[c] for c in ("size", "insert_ts", "last_ts", "freq"))

# NVIDIA H100 SXM, HBM3 (data sheet).
HBM_BYTES_PER_S = 3.35e12

# The parts of a step's need; in the program's fused step, the kernels
# access_probe, hit_metadata_update, ranked_eviction and drop_scatter do
# them one each; no kernel of its own reads the values GETs return.
PARTS = ("probe", "hit_meta", "eviction", "apply", "read")


def call_bytes(groups, is_write, hits, counters, *, n_buckets, assoc,
               n_samples, n_experts, value_words):
    """The bytes of each part over one call's steps.

    groups, is_write, hits: [steps, ...] arrays, one step's requests a
    leading index (key 0: none); counters: the call's ``OpStats`` deltas
    (``misses``, ``insert_drops``, ``evictions``, ``fc_flushes``)."""
    value = 4 * int(value_words)
    slot = sum(WIDTH.values()) + value
    groups = np.asarray(groups).reshape(len(groups), -1)
    is_write = np.asarray(is_write, bool).reshape(groups.shape)
    hits = np.asarray(hits, bool).reshape(groups.shape)
    live = groups != 0
    bk = buckets_of(groups, n_buckets)
    probe = hit_meta = 0
    for s in range(groups.shape[0]):
        m = live[s]
        probe += np.unique(bk[s][m]).size * assoc * PROBED
        probe += int(m.sum()) * (WIDTH["key"] + 1 + 4)
        hit = m & hits[s]
        # Distinct keys hit in a step are distinct slots.
        hit_meta += np.unique(groups[s][hit]).size * (
            2 * WIDTH["last_ts"] + WIDTH["freq"] + 2 * WIDTH["ext"])
    hit_meta += int(counters["fc_flushes"]) * 2 * WIDTH["freq"]
    evictions = int(counters["evictions"])
    eviction = evictions * (n_samples * SAMPLED + 4 * n_experts + 4)
    inserts = int(counters["misses"]) - int(counters["insert_drops"])
    set_hits = int((live & hits & is_write).sum())
    get_hits = int((live & hits & ~is_write).sum())
    apply = (set_hits * (value + WIDTH["size"]) + inserts * slot
             + evictions * (WIDTH["size"] + WIDTH["ptr"]
                            + WIDTH["insert_ts"]))
    return dict(probe=probe, hit_meta=hit_meta, eviction=eviction,
                apply=apply, read=get_hits * value)


def roofline_share(n_bytes, seconds):
    """The share (%) of the least time ``n_bytes`` take at the HBM peak
    in ``seconds`` of device time; None where nothing was timed."""
    if not seconds or seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
