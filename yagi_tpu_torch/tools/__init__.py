"""Measurement tools for the port's kernels on the card: device timing
(:mod:`.timing`), the paths' shapes and inputs (:mod:`.paths`), the A/B of a
kernel's versions (:mod:`.kernel_ab`) and the eager step profile
(:mod:`.step_profile`); and one rank of the multi-process ``parallel/``
checks (:mod:`.multihost_worker`)."""
