"""The 95th percentile (nearest rank) over all blocks of the window of a
block's latency in ms: from its hand-over to the entry to the moment the host
saw its event complete, two blocks in flight."""

from portbench.core.stats import percentile


def read(rec) -> float:
    return 1e3 * percentile(rec.window.latencies, 95)
