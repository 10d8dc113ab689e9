"""Seconds from the process's start to the first timed block: imports, the
kernels' library (built on the first run in a checkout, loaded after), the
filter designs, the inputs made on the card and the warm-up blocks."""


def read(rec) -> float:
    return rec.setup_s
