"""Device ms a step in operations that are not the port's own CUDA kernels
(``yagi_tpu_torch/csrc``): torch's copies, fills and elementwise kernels
between them."""

import re


def read(rec):
    s = rec.slice
    if s is None or not s.steps:
        return None
    own = re.compile(r"\b(" + "|".join(map(re.escape, rec.port_kernels)) + r")\b")
    glue = sum(o.end - o.start for o in s.ops if not own.search(o.name))
    return 1e3 * glue / s.steps
