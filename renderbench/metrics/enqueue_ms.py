"""enqueue_ms (ms): the median host time of one call of the program in the
window (jit's key, the copies of the leaves, graph.replay() and the
output clones being issued), by the host clock."""

import statistics


def read(t: dict):
    ms = t.get("enqueue_ms")
    if not ms:
        return None
    return statistics.median(ms)
