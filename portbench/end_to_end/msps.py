"""Complex input samples of every block completed in the window, in millions,
over the window's seconds (hand-over of the first block to the closing
synchronize)."""


def read(rec) -> float:
    return rec.window.blocks * rec.samples_per_block / rec.window.seconds / 1e6
